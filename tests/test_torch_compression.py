"""repro_torch.parallel.compression against the reference, bit for bit.

The halo codec: ``pack_halo`` words equal the reference's int32 words for
color bounds across 16, 4, 3, 2 and 1 entries per word, with and without
leading batch dimensions, and ``unpack_halo`` inverts them. The int8 psum:
``_quantize`` given ``jax.random.uniform(key, x.shape)`` as its draws
returns the compiled reference's ``q`` and ``scale`` exactly, and the gloo sum over
2 and 4 ranks (CPU tensors, one process per rank) of those payloads, with
the same draws in every rank, equals the reference's ``compressed_psum``
on a CPU mesh of the same size in float32 bits.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import run_ranks
from repro_torch.parallel import (compressed_psum, halo_bits, halo_bytes,
                                  halo_words, pack_halo, unpack_halo)
from repro_torch.parallel.compression import _quantize

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")
# inclusive color bounds -> entries per word: 16, 4, 4, 3, 3, 2, 1, 1
BOUNDS = [1, 64, 127, 143, 511, 5000, 70000, (1 << 20) + 3]
NUM_RANKS = (2, 4)


def _entries(shape, bound, seed):
    rng = np.random.default_rng(seed)
    colors = rng.integers(0, bound + 1, shape).astype(np.int32)
    colors.reshape(-1)[:2] = [bound, 0][:colors.size]   # the field's ends
    pending = rng.random(shape) < 0.5
    return colors, pending


@pytest.mark.parametrize("shape", [(0,), (1,), (37,), (3, 2, 41)],
                         ids=["n0", "n1", "n37", "batched"])
@pytest.mark.parametrize("bound", BOUNDS)
def test_pack_halo_words_are_the_reference_words(bound, shape):
    from repro.parallel import compression as RC
    import jax.numpy as jnp
    if 0 in shape:
        colors = np.zeros(shape, np.int32)
        pending = np.zeros(shape, np.bool_)
    else:
        colors, pending = _entries(shape, bound, seed=bound % 97)
    want = np.asarray(RC.pack_halo(jnp.asarray(colors), jnp.asarray(pending),
                                   bound))
    got = pack_halo(torch.from_numpy(colors), torch.from_numpy(pending), bound)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    n = shape[-1]
    assert got.shape[-1] == halo_words(n, bound) == RC.halo_words(n, bound)
    assert halo_bits(bound) == RC.halo_bits(bound)
    assert halo_bytes(n, bound, 4) == RC.halo_bytes(n, bound, 4)
    c, p = unpack_halo(got, n, bound)
    np.testing.assert_array_equal(c.numpy(), colors)
    np.testing.assert_array_equal(p.numpy(), pending)
    rc, rp = RC.unpack_halo(jnp.asarray(want), n, bound)
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(p.numpy(), np.asarray(rp))


@pytest.fixture(scope="module")
def draws():
    """x [4, 64] float32 (one row per rank) and the reference's uniform
    draws for PRNGKey(0), as the reference's own psum test uses them."""
    import jax
    x = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32)
    x[2] *= 3.0                     # ranks with different scales
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (64,)))
    return x, u


@pytest.mark.parametrize("row", range(4))
def test_quantize_with_the_reference_draws(row, draws):
    import jax
    from repro.parallel import compression as RC
    x, u = draws
    # compiled, as the reference's psum runs it
    q_want, s_want = jax.jit(RC._quantize)(jax.numpy.asarray(x[row]),
                                           jax.random.PRNGKey(0))
    q, s = _quantize(torch.tensor(x[row]), torch.tensor(u))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_want))
    assert s.numpy().view(np.int32) == np.asarray(s_want).view(np.int32)


def psum_rank(mesh, x, u):
    """One rank's compressed_psum of its row, float32 bits out."""
    y = compressed_psum(torch.tensor(x[mesh.rank], dtype=torch.float32),
                        mesh.group,
                        uniform=torch.tensor(u, dtype=torch.float32))
    return y.view(torch.int32).tolist()


_REF_PSUM = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {src!r})
from repro.jax_compat import shard_map
from repro.parallel.compression import compressed_psum
x = np.asarray(json.loads(sys.argv[1]), np.float32)
out = {{}}
for D in {ranks!r}:
    mesh = jax.make_mesh((D,), ("d",), devices=jax.devices()[:D])
    f = shard_map(lambda v: compressed_psum(v[0], "d", jax.random.PRNGKey(0)),
                  mesh=mesh, in_specs=P("d", None), out_specs=P())
    y = np.asarray(jax.jit(f)(jnp.asarray(x[:D])), np.float32)
    out[str(D)] = y.view(np.int32).tolist()
print(json.dumps(out))
"""


def test_compressed_psum_over_gloo_ranks_is_the_reference_sum(draws,
                                                             tmp_path):
    x, u = draws
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c",
         _REF_PSUM.format(src=SRC, ranks=list(NUM_RANKS)),
         json.dumps(x.tolist())],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        got = {D: run_ranks("test_torch_compression:psum_rank", D,
                            dict(x=x.tolist(), u=u.tolist()), device="cpu",
                            timeout=120, workdir=str(tmp_path / f"r{D}"))
               for D in NUM_RANKS}
        out, err = ref.communicate(timeout=120)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-4000:]
    want = json.loads(out.strip().splitlines()[-1])
    for D in NUM_RANKS:
        for r, bits in enumerate(got[D]):
            assert bits == want[str(D)], f"D={D} rank {r}"
        exact = x[:D].sum(0)
        y = np.asarray(want[str(D)], np.int32).view(np.float32)
        assert np.abs(y - exact).max() <= np.abs(x[:D]).max() / 127 * D * 1.5


def test_compressed_psum_alone_draws_from_its_generator():
    x = torch.from_numpy(
        np.random.default_rng(1).normal(size=(256,)).astype(np.float32))
    a = compressed_psum(x, None, torch.Generator().manual_seed(5))
    b = compressed_psum(x, None, torch.Generator().manual_seed(5))
    c = compressed_psum(x, None, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    scale = float(x.abs().max()) / 127
    assert float((a - x).abs().max()) <= scale * (1 + 1e-6)
