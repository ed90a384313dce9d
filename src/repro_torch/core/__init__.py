"""Integer core: bit packing, binarization helpers and RBMM dispatch."""
