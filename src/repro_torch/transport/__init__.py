"""Moving experts between hosts: port of ``repro/transport/``.

The wire format (:mod:`.wire`) serializes one expert into a
self-describing, checksummed blob, byte for byte the reference's; the
backends (:mod:`.backends`) move blobs over memory, a filesystem, a
simulated link or HTTP, all behind one retry/backoff policy
(:mod:`.retry`); the chaos wrapper (:mod:`.chaos`) injects deterministic
faults; :mod:`.replication` fronts a fleet of replicas.  The serving
stack's remote tier
(:class:`repro_torch.serve.expert_cache.RemoteExpertStore`) is built on
this package.  Every fetch decodes to the host.
"""

from repro_torch.transport.backends import (ExpertTransport, HTTPTransport,
                                            InMemoryTransport, LocalTransport,
                                            SimulatedNetworkTransport,
                                            TransportStats, serve_local_http)
from repro_torch.transport.chaos import (ChaosFault, ChaosTransport,
                                         ReplicaFault)
from repro_torch.transport.replication import ReplicatedTransport
from repro_torch.transport.retry import (DeadlineExceeded, ExpertNotFound,
                                         FetchTimeout, ReplicaUnreachable,
                                         RetriesExhausted, RetryPolicy,
                                         TransientTransportError,
                                         is_retryable)
from repro_torch.transport.wire import (MAGIC, VERSION, WIRE_FORMAT,
                                        WIRE_SUFFIX, ChecksumError,
                                        TransportError, WireFormatError,
                                        decode_expert, decode_leaves,
                                        encode_expert, is_wire_blob,
                                        payload_offset, peek_manifest,
                                        supports_resume, verify_leaf,
                                        wire_nbytes)

__all__ = ["ExpertTransport", "HTTPTransport", "InMemoryTransport",
           "LocalTransport", "SimulatedNetworkTransport", "TransportStats",
           "serve_local_http", "ChaosFault", "ChaosTransport", "ReplicaFault",
           "ReplicatedTransport", "DeadlineExceeded", "ExpertNotFound",
           "FetchTimeout", "ReplicaUnreachable", "RetriesExhausted",
           "RetryPolicy", "TransientTransportError", "is_retryable", "MAGIC",
           "VERSION", "WIRE_FORMAT", "WIRE_SUFFIX", "ChecksumError",
           "TransportError", "WireFormatError", "decode_expert",
           "decode_leaves", "encode_expert", "is_wire_blob", "payload_offset",
           "peek_manifest", "supports_resume", "verify_leaf", "wire_nbytes"]
