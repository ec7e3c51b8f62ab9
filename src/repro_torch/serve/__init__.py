from repro_torch.serve.decode_loop import PAD_TOKEN, SamplingConfig
from repro_torch.serve.engine import (DONE, FAILED, PENDING, EngineConfig,
                                      Request, ServeEngine)
from repro_torch.serve.expert_cache import (BASE, DeviceCache,
                                            ExpertRegistry, ExpertStore,
                                            ExpertUnavailable,
                                            RemoteExpertStore, SwapStats,
                                            uncompressed_baseline_bytes)
from repro_torch.serve.journal import (JournalState, JournalWriter,
                                       read_records, replay)
from repro_torch.serve.paged_kv import (BlockAllocator, blocks_for,
                                        init_paged_cache)
from repro_torch.serve.scheduler import (SCHEDULERS, AffinityScheduler,
                                         FIFOScheduler, PriorityScheduler,
                                         make_scheduler)
from repro_torch.serve.snapshot import (Snapshot, load_snapshot,
                                        write_snapshot)

__all__ = ["PAD_TOKEN", "SamplingConfig", "DONE", "FAILED", "PENDING",
           "EngineConfig", "Request", "ServeEngine", "BASE", "DeviceCache",
           "ExpertRegistry", "ExpertStore", "ExpertUnavailable",
           "RemoteExpertStore", "SwapStats", "uncompressed_baseline_bytes",
           "JournalState", "JournalWriter", "read_records", "replay",
           "BlockAllocator", "blocks_for", "init_paged_cache",
           "FIFOScheduler", "PriorityScheduler", "AffinityScheduler",
           "SCHEDULERS", "make_scheduler",
           "Snapshot", "load_snapshot", "write_snapshot"]
