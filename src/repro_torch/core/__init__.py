"""repro_torch.core — parallel greedy graph coloring on PyTorch and CUDA.

Public API (names as in the reference ``repro.core``):
  color(graph, spec, device=)    the front door: one-shot spec -> report
  ColoringSpec / compile_plan /  declarative spec; a plan serving
  ColoringPlan / ColoringReport  same-bucket graphs with one program build
  ColoringStrategy /             the algorithm registry: "iterative" |
  register_strategy              "dataflow" | "distributed" | "recolor"
  Graph / BipartiteGraph /       host CSR (with edge deltas); two-sided
  DeviceGraph                    bipartite CSR; int32 tensors on one device
                                 (edge list / CSR / ELL layouts)
  rmat.generate / paper_graph    R-MAT test-graph generation (paper §4)
  greedy_color                   serial distance-1 oracle (Alg. 1)
  greedy_color_d2 / _pd2         serial distance-2 / partial-D2 oracles
  color_iterative                speculation+iteration (Alg. 2)
  color_dataflow                 dataflow fixpoint (Alg. 3-5)
  dataflow_levels                DAG depth / wavefront profile
  color_distributed              BSP over the ranks of a ProcessMesh
  ProcessMesh / partition_graph  a torch.distributed group as a mesh;
  / ShardLayout                  host partitioning into shard-local CSR +
                                 boundary halos
  schedule_transfers /           coloring-driven collective scheduling
  CommSchedule
  model="d1"|"d2"|"pd2"          coloring model on every strategy;
  distance2                      the model layer: square, partial_square,
                                 d2_device_graph, pd2_device_graph
  DynamicColoring / DeltaReport  streaming edge deltas repaired in place
                                 by the "recolor" strategy's warm start
  engine                         pluggable first-fit backends:
                                 engine="sort" | "bitmap" | "ell_pallas" |
                                 "fused_pallas" (the last two run the CUDA
                                 firstfit / round_fused kernels)
  frontier                       active-set execution for rounds >= 1
  validate_coloring / _d2 / _pd2 per-model validity + conflict counting

``device=None`` means the card; pass ``device="cpu"`` for the host.
"""
from .graph import BipartiteGraph, DeviceGraph, Graph, pad_bucket, \
    resolve_device
from . import distance2, engine, frontier, ordering, rmat
from .engine import (MexBackend, available_backends, get_backend,
                     register_backend)
from .distance2 import partial_square, square
from .greedy_ref import greedy_color, greedy_color_d2, greedy_color_pd2
from .iterative import ColoringResult, color_iterative
from .dataflow import DataflowResult, color_dataflow, dataflow_levels
from .graph import ShardLayout
from .distributed import ProcessMesh, color_distributed, partition_graph
from .comm_schedule import CommSchedule, schedule_transfers
from .metrics import (count_conflicts, count_d2_conflicts,
                      count_pd2_conflicts, num_colors, validate_coloring,
                      validate_d2_coloring, validate_pd2_coloring)
from . import api
from .api import (ColoringPlan, ColoringReport, ColoringSpec,
                  ColoringStrategy, PlanShape, available_strategies, color,
                  compile_plan, get_strategy, register_strategy)
from . import dynamic
from .dynamic import DeltaReport, DynamicColoring

__all__ = [
    "api", "color", "compile_plan", "ColoringSpec", "ColoringPlan",
    "ColoringReport", "ColoringStrategy", "PlanShape", "register_strategy",
    "get_strategy", "available_strategies", "Graph", "BipartiteGraph",
    "DeviceGraph", "pad_bucket", "resolve_device", "rmat", "ordering",
    "engine", "distance2", "frontier", "dynamic", "DynamicColoring",
    "DeltaReport", "square", "partial_square", "greedy_color",
    "greedy_color_d2", "greedy_color_pd2", "MexBackend",
    "available_backends", "get_backend", "register_backend",
    "color_iterative", "ColoringResult", "color_dataflow", "DataflowResult",
    "dataflow_levels",
    "color_distributed", "ProcessMesh", "partition_graph", "ShardLayout",
    "schedule_transfers", "CommSchedule",
    "validate_coloring", "count_conflicts", "num_colors",
    "validate_d2_coloring", "count_d2_conflicts", "validate_pd2_coloring",
    "count_pd2_conflicts",
]
