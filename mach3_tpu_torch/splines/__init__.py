from .eval import eval_dense, find_segments, spline_product
from .monolith import DenseSplineTable, SplineParamSpec, build_dense_table

__all__ = [
    "eval_dense",
    "find_segments",
    "spline_product",
    "DenseSplineTable",
    "SplineParamSpec",
    "build_dense_table",
]
