"""Distribution of the port: the serving mesh's placement rules
(:mod:`.sharding`) and collectives (:mod:`.collectives`), and the fault
accounting shared by the serving tiers (:mod:`.fault`)."""

from repro_torch.distributed.collectives import RowLayout, ServeComm
from repro_torch.distributed.fault import (ElasticPlan, FailureInjector,
                                           SimulatedFailure,
                                           StragglerMonitor)
from repro_torch.distributed.sharding import (local_shard,
                                              serve_kv_sharding,
                                              serve_param_shardings,
                                              serve_row_shards,
                                              serve_stack_shardings,
                                              shard_params)

__all__ = ["ElasticPlan", "FailureInjector", "SimulatedFailure",
           "StragglerMonitor", "RowLayout", "ServeComm", "local_shard",
           "serve_kv_sharding", "serve_param_shardings", "serve_row_shards",
           "serve_stack_shardings", "shard_params"]
