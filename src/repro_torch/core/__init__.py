"""repro_torch.core — parallel greedy graph coloring on PyTorch and CUDA.

Public API (names as in the reference ``repro.core``):
  color(graph, spec, device=)    the front door: one-shot spec -> report
  ColoringSpec / compile_plan /  declarative spec; a plan serving
  ColoringPlan / ColoringReport  same-bucket graphs with one program build
  ColoringStrategy /             the algorithm registry: "iterative" |
  register_strategy              "dataflow"
  Graph / DeviceGraph            host CSR; int32 tensors on one device
                                 (edge list / CSR / ELL layouts)
  rmat.generate / paper_graph    R-MAT test-graph generation (paper §4)
  greedy_color                   serial distance-1 oracle (Alg. 1)
  color_iterative                speculation+iteration (Alg. 2)
  color_dataflow                 dataflow fixpoint (Alg. 3-5)
  engine                         pluggable first-fit backends:
                                 engine="sort" | "bitmap" | "ell_pallas" |
                                 "fused_pallas" (the last two run the CUDA
                                 firstfit / round_fused kernels)
  frontier                       active-set execution for rounds >= 1
  validate_coloring              validity + conflict counting

``device=None`` means the card; pass ``device="cpu"`` for the host.
"""
from .graph import DeviceGraph, Graph, pad_bucket, resolve_device
from . import engine, frontier, ordering, rmat
from .engine import (MexBackend, available_backends, get_backend,
                     register_backend)
from .greedy_ref import greedy_color
from .iterative import ColoringResult, color_iterative
from .dataflow import DataflowResult, color_dataflow
from .metrics import count_conflicts, num_colors, validate_coloring
from . import api
from .api import (ColoringPlan, ColoringReport, ColoringSpec,
                  ColoringStrategy, PlanShape, available_strategies, color,
                  compile_plan, get_strategy, register_strategy)

__all__ = [
    "api", "color", "compile_plan", "ColoringSpec", "ColoringPlan",
    "ColoringReport", "ColoringStrategy", "PlanShape", "register_strategy",
    "get_strategy", "available_strategies", "Graph", "DeviceGraph",
    "pad_bucket", "resolve_device", "rmat", "ordering", "engine",
    "frontier", "greedy_color", "MexBackend", "available_backends",
    "get_backend", "register_backend", "color_iterative", "ColoringResult",
    "color_dataflow", "DataflowResult", "validate_coloring",
    "count_conflicts", "num_colors",
]
