"""Distribution of the port: the serving and training meshes' placement
rules (:mod:`.sharding`) and collectives (:mod:`.collectives`), and the
fault accounting shared by the serving tiers (:mod:`.fault`)."""

from repro_torch.distributed.collectives import (MeshComm, RowLayout,
                                                 ServeComm, batch_axes_of,
                                                 flash_combine,
                                                 make_sp_cross_attn,
                                                 make_sp_decode_attn,
                                                 make_vp_embed_lookup,
                                                 shard_decode_cache)
from repro_torch.distributed.fault import (ElasticPlan, FailureInjector,
                                           SimulatedFailure,
                                           StragglerMonitor)
from repro_torch.distributed.sharding import (assemble, batch_axes,
                                              batch_shardings,
                                              cache_placement, cache_pspec,
                                              cache_shardings, decode_layout,
                                              heads_shardable, local_shard,
                                              param_pspec, param_shardings,
                                              replicated,
                                              serve_cache_shardings,
                                              serve_kv_sharding,
                                              serve_param_shardings,
                                              serve_row_shards,
                                              serve_stack_shardings,
                                              shard_params, shard_tree,
                                              train_state_shardings)

__all__ = ["ElasticPlan", "FailureInjector", "SimulatedFailure",
           "StragglerMonitor", "RowLayout", "ServeComm", "local_shard",
           "serve_kv_sharding", "serve_param_shardings", "serve_row_shards",
           "serve_stack_shardings", "shard_params", "serve_cache_shardings",
           "assemble", "shard_tree", "batch_axes", "param_pspec",
           "heads_shardable", "param_shardings", "train_state_shardings",
           "batch_shardings", "replicated", "decode_layout", "cache_pspec",
           "cache_shardings", "flash_combine", "make_sp_decode_attn",
           "shard_decode_cache", "batch_axes_of", "make_vp_embed_lookup",
           "MeshComm", "make_sp_cross_attn", "cache_placement"]
