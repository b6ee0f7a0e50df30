"""The frozen roofline model at the kernel table's shapes (PERF.md): it gives
that table's bounds, which count the bytes read and the bytes written,
except for conflict_mask's endpoint ids read where colors tie (8 bytes a
tied edge), which the launch geometry does not carry."""
import pytest

from portbench import roofline

# (kernel, rows, width, the table's bound in ms) at the main, skew and d2
# shapes and conflict_mask's edge count
TABLE = [("firstfit", 4_194_304, 39, 0.2003),
         ("firstfit", 65_536, 1_999, 0.1565),
         ("firstfit", 262_144, 617, 0.1934),
         ("round_fused", 4_194_304, 39, 0.2103),
         ("round_fused", 65_536, 1_999, 0.1567),
         ("round_fused", 262_144, 617, 0.1941),
         ("conflict_mask", 67_108_762, 1, 0.2404)]


@pytest.mark.parametrize("kernel,rows,width,table_ms", TABLE)
def test_bounds_of_the_kernel_table(kernel, rows, width, table_ms):
    ms = 1e3 * roofline.bound_s(kernel, rows, width)
    assert round(ms, 4) == table_ms


def test_conflict_mask_leaves_out_the_tied_ids():
    # 12 bytes an edge: two colors read, one flag written
    assert roofline.launch_bytes("conflict_mask", 1000, 1) == 12_000


def test_kernel_names():
    assert roofline.kernel_of("void repro_torch::slab_rows_kernel<1, 4, true,"
                              " true>(repro_torch::SlabArgs)") == "round_fused"
    assert roofline.kernel_of("void repro_torch::slab_rows_kernel<0, 32, "
                              "false, false>(repro_torch::SlabArgs)") \
        == "firstfit"
    assert roofline.kernel_of("repro_torch::conflict_kernel(int const*)") \
        == "conflict_mask"
    assert roofline.kernel_of("Memcpy HtoD (Pageable -> Device)") is None
    with pytest.raises(ValueError):
        roofline.launch_bytes("cummax", 1, 1)
