from .eval import eval_dense, eval_sparse, eval_sparse_batched, find_segments, spline_product
from .monolith import (
    DenseSplineTable,
    SparseSplineTable,
    SplineParamSpec,
    build_dense_table,
    build_sparse_table,
    load_table,
    save_table,
)

__all__ = [
    "eval_dense",
    "eval_sparse",
    "eval_sparse_batched",
    "find_segments",
    "spline_product",
    "DenseSplineTable",
    "SparseSplineTable",
    "SplineParamSpec",
    "build_dense_table",
    "build_sparse_table",
    "load_table",
    "save_table",
]
