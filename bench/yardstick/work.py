"""What a sparse neighbour sum needs on the real graph, whatever computes
it: no padded row, no pack and no block counted."""
from __future__ import annotations


def spmm(arcs: int, in_rows: int, out_rows: int, width: int) -> tuple:
    """(flops, bytes) of summing ``arcs`` weighted rows of width ``width``:
    a multiply and an add per arc and column; each arc's weight and source
    index read once (4 bytes each), each of the ``in_rows`` feature rows
    read once and each of the ``out_rows`` output rows written once, in
    float32."""
    flops = 2.0 * arcs * width
    nbytes = 8.0 * arcs + 4.0 * width * (in_rows + out_rows)
    return flops, nbytes
