from repro_torch.core.compeft import (STREAM_COLS, CompressionConfig,
                                      compress_packed)
from repro_torch.core.packing import (LANE, PackedTernary, pack_bits,
                                      stack_packed, stacked_bytes,
                                      tree_packed_bytes, unpack_bits)

__all__ = ["STREAM_COLS", "CompressionConfig", "compress_packed", "LANE",
           "PackedTernary", "pack_bits", "stack_packed", "stacked_bytes",
           "tree_packed_bytes", "unpack_bits"]
