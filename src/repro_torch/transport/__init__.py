"""Moving experts between hosts: the checksummed wire format.

Port of ``repro/transport/`` cut to its container, :mod:`.wire`; the
backends, retry and replication come with ROADMAP queue 1, item 8.
"""

from repro_torch.transport.wire import (MAGIC, VERSION, WIRE_FORMAT,
                                        WIRE_SUFFIX, ChecksumError,
                                        TransportError, WireFormatError,
                                        decode_expert, decode_leaves,
                                        encode_expert, is_wire_blob,
                                        payload_offset, peek_manifest,
                                        supports_resume, verify_leaf,
                                        wire_nbytes)

__all__ = ["MAGIC", "VERSION", "WIRE_FORMAT", "WIRE_SUFFIX",
           "ChecksumError", "TransportError", "WireFormatError",
           "decode_expert", "decode_leaves", "encode_expert", "is_wire_blob",
           "payload_offset", "peek_manifest", "supports_resume",
           "verify_leaf", "wire_nbytes"]
