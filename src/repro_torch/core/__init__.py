from repro_torch.core.compeft import (ALPHA_GRID, DENSITY_GRID, STREAM_COLS,
                                      CompressedTensor, CompressionConfig,
                                      apply_compressed, calibrate_alpha,
                                      compress, compress_leaf,
                                      compress_packed, compress_packed_exact,
                                      compression_summary, decompress,
                                      rescale)
from repro_torch.core.packing import (LANE, PackedTernary, entropy_bits,
                                      golomb_bits_per_position,
                                      golomb_total_bits, pack_bits,
                                      pack_ternary, pack_tree, stack_packed,
                                      stacked_bytes, tree_packed_bytes,
                                      unpack_bits, unpack_ternary,
                                      unpack_tree)

__all__ = [
    "ALPHA_GRID", "DENSITY_GRID", "STREAM_COLS", "CompressedTensor",
    "CompressionConfig", "apply_compressed", "calibrate_alpha", "compress",
    "compress_leaf", "compress_packed", "compress_packed_exact",
    "compression_summary", "decompress", "rescale", "LANE", "PackedTernary",
    "entropy_bits", "golomb_bits_per_position", "golomb_total_bits",
    "pack_bits", "pack_ternary", "pack_tree", "stack_packed",
    "stacked_bytes", "tree_packed_bytes", "unpack_bits", "unpack_ternary",
    "unpack_tree"]
