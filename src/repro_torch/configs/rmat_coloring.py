"""The paper's own workload as a first-class config: distributed BSP
speculative coloring (core/distributed.py) of the paper's R-MAT graphs.
A copy of the reference's ``repro.configs.rmat_coloring`` with the same
numbers; its specs resolve against ``repro_torch.core.api``.

Scales follow the paper's Table 4 (scale-24..27, edge factor 8); the
reference's dry-run lowers the scale given by ``dryrun_scale`` (default 24:
16.7M vertices, ~134M undirected edges -> ~268M directed, ~1M directed
edges per device slab at 512 devices with padding).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ColoringConfig:
    name: str = "rmat-coloring"
    family: str = "coloring"
    dryrun_scale: int = 24
    edge_factor: int = 8
    params: tuple = (0.55, 0.15, 0.15, 0.15)   # RMAT-B, the hostile one
    max_rounds: int = 64
    local_concurrency: int = 1
    # first-fit mex backend for the local solve: a name registered with
    # repro_torch.core.engine. The dry-run lowers "sort" and "bitmap";
    # "ell_pallas" needs a real host graph (for the ELL width) and is only
    # reachable through color_distributed.
    engine: str = "sort"
    # coloring model ("d1" | "d2" | "pd2" — repro_torch.core.distance2). At
    # dry-run time the model only changes the constraint-slab width (D2
    # edges ~ avg_degree x the D1 count) and the color-bound headroom; the
    # lowered BSP program is otherwise identical.
    model: str = "d1"
    # static color-capacity bound for the bitmap backend at dry-run time
    # (no host graph to read max_degree from; greedy on the paper's graphs
    # stays <= 143 colors, so 512 leaves ample headroom; D2 colorings use
    # up to ~avg_degree x more — still far below 512 at edge factor 8)
    color_bound: int = 512
    # vertex-visit ordering (repro_torch.core.ordering.ORDERINGS). Purely a
    # runtime (host-relabel) knob: the dry-run lowering is ordering-
    # invariant, since a relabeled graph has identical slab shapes.
    ordering: str = "natural"
    # frontier execution (repro_torch.core.frontier): "auto"/"on" compact
    # rounds >= 1 into per-shard active-set slabs and shrink the wire to
    # the frontier halo when every device's pending set fits; "off" sweeps
    # the full slab every round. Capacities ride the pad_bucket ladder off
    # the per-device slab shape, so the lowered program stays static.
    frontier: str = "auto"
    frontier_capacity: int = 0
    # distributed per-round exchange (repro_torch.core.distributed): "auto"/
    # "boundary" exchange only the bit-packed boundary payload (the
    # default three-tier wire), "full" the legacy [Vp] gather. The dry-run
    # lowers the boundary program with a conservative halo slab (Bl = Vl:
    # every vertex boundary — shapes only, no host graph to classify with).
    wire: str = "auto"
    # vertex ownership: "1d" contiguous blocks, "2d" block-cyclic over a
    # device grid — spreads R-MAT hub regions so one shard doesn't carry
    # both the widest edge slab and the densest boundary. Shape-invariant
    # at dry-run time (ownership only permutes ids).
    partition: str = "1d"

    def to_dynamic_spec(self):
        """This config as the streaming-lane :class:`ColoringSpec`: the
        registered ``"recolor"`` strategy with this config's engine /
        bounds / frontier knobs — what a
        :class:`repro_torch.core.dynamic.DynamicColoring` over the paper's
        workload runs when the R-MAT graph arrives as edge-delta batches
        instead of one static snapshot. Distance-1 only — the streaming
        layer's endpoint seeding under-repairs richer models, so a
        d2/pd2 config raises here instead of silently coercing."""
        if self.model != "d1":
            raise ValueError(
                f"streaming (recolor) is distance-1 only; config has "
                f"model={self.model!r}")
        from repro_torch.core.api import ColoringSpec
        return ColoringSpec(strategy="recolor", engine=self.engine,
                            ordering="natural",  # recolor repairs in place
                            max_rounds=self.max_rounds,
                            color_bound=self.color_bound,
                            frontier=self.frontier,
                            frontier_capacity=self.frontier_capacity)

    def to_spec(self, mesh=None):
        """This config as a :class:`repro_torch.core.api.ColoringSpec` for the
        registered ``"distributed"`` strategy — the runtime counterpart of
        the program the dry-run lowers (same engine/model/bounds), usable
        with ``repro_torch.core.color`` / ``compile_plan`` directly."""
        from repro_torch.core.api import ColoringSpec
        return ColoringSpec(strategy="distributed", model=self.model,
                            engine=self.engine, ordering=self.ordering,
                            max_rounds=self.max_rounds,
                            # the BSP local solve's sweep cap (not a config
                            # knob): match build_distributed_coloring's
                            # default so this spec compiles the SAME program
                            # the dry-run lowers and the legacy shim runs
                            max_sweeps=16384,
                            local_concurrency=self.local_concurrency,
                            color_bound=self.color_bound, mesh=mesh,
                            frontier=self.frontier,
                            frontier_capacity=self.frontier_capacity,
                            wire=self.wire, partition=self.partition)


def get_config() -> ColoringConfig:
    return ColoringConfig()


def get_smoke_config() -> ColoringConfig:
    return ColoringConfig(name="rmat-coloring-smoke", dryrun_scale=10)
