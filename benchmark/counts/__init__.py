"""Operations and bytes of the kernels and steps the benchmark reads
rooflines and ``mfu`` against, computed from shapes alone."""
