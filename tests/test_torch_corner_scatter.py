"""The corner gather and its backward, the vertex gradient's scatter by
triangle (csrc/corner_scatter.cu), built as host C++ (each block's threads
run in turn between barriers, so the kernels' own sort, trees and combine
run), against the plain version (autograd of `rows[idx][:, :9]`), the
JAX package's gather `rows_tbl[idx][:, 0:9]` (tpu_ray/render/render.py:615)
transposed by `jax.vjp`, and a float64 `np.add.at`; and the wrapper's
dispatch and checks (kernels/cuda_scatter.py).

The rule: each entry of the gradient within 1e-5 of the float64 sum,
relative to the sum of its terms' absolute values (the kernel sums a
triangle's rows in another order than a serial float32 sum: a tree within
each tile of 1,024 rays, then a tree over the tiles), against the float64
sum, the plain version and JAX's transpose alike; column 9 exactly zero. The
gather is a copy: bit-equal.

Index sets: `tools/profile_scatter`'s `local` (2,000 neighbouring
triangles) and `uniform` (any of 70,000) blocks; one id for every ray;
long runs interleaved with singletons; misses clamped to triangle 0 with
a zero cotangent; R not a multiple of the tile; more than 64 tiles (a
triangle's mask of tiles in two words); a small `mixed` frame's own ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_host_build
from tpu_ray_torch.kernels import cuda_scatter
from tpu_ray_torch.tools import profile_scatter

T = profile_scatter.T


@pytest.fixture(scope="module")
def so(tmp_path_factory):
    so = torch_host_build.build_scatter(tmp_path_factory.mktemp("host_scatter"))
    if so is None:
        pytest.skip("no g++ to build the kernel arithmetic as host code")
    return so


def _runs_and_singletons(rng):
    parts = []
    while sum(map(len, parts)) < 20_000:
        parts.append(np.full(int(rng.integers(200, 3000)), rng.integers(0, T)))
        parts.append(rng.integers(0, T, int(rng.integers(1, 40))))
    return np.concatenate(parts)


def _misses(rng):
    """Hits on a few hundred triangles, a third of the rays missing: their
    ids clamped to 0, their cotangent zero."""
    idx = rng.integers(100, 400, 24_576)
    miss = rng.random(idx.shape[0]) < 1 / 3
    idx[miss] = 0
    return idx, miss


def _case(name):
    """(ids, cotangent) of an index set, drawn from numpy's default_rng(0)
    (the profile tool's sets in its order)."""
    rng = np.random.default_rng(0)
    R = profile_scatter.R_BLOCK
    local = rng.integers(0, 2000, R) + 30_000
    uniform = rng.integers(0, T, R)
    d = rng.standard_normal((R, 9), np.float32)
    if name == "local":
        return local, d
    if name == "uniform":
        return uniform, d
    if name == "one_id":
        return np.full(R, 12_345), d
    if name == "runs_and_singletons":
        idx = _runs_and_singletons(rng)
        return idx, rng.standard_normal((idx.shape[0], 9), np.float32)
    if name == "misses_clamped_to_0":
        idx, miss = _misses(rng)
        ct = rng.standard_normal((idx.shape[0], 9), np.float32)
        ct[miss] = 0.0
        return idx, ct
    if name == "ragged":  # R not a multiple of the tile (1,024)
        idx = rng.integers(0, 300, 5_000)
        return idx, rng.standard_normal((idx.shape[0], 9), np.float32)
    if name == "over_64_tiles":  # 70,000 rays: 69 tiles, two mask words
        idx = np.concatenate([np.sort(rng.integers(0, 5_000, 60_000)),
                              rng.integers(0, T, 10_000)])
        idx[::7] = 4_321
        return idx, rng.standard_normal((idx.shape[0], 9), np.float32)
    raise ValueError(name)


CASES = ["local", "uniform", "one_id", "runs_and_singletons", "misses_clamped_to_0",
         "ragged", "over_64_tiles"]


def _jax_scatter(idx, ct, n_tris):
    """The (n_tris, 10) cotangent of the table from the corners' cotangent
    ct, by jax.vjp of the JAX package's gather (`rows_tbl[idx][:, 0:9]`,
    tpu_ray/render/render.py:615), float32 on the CPU."""
    rows = jnp.zeros((n_tris, 10), jnp.float32)
    _, vjp = jax.vjp(lambda r: r[jnp.asarray(idx)][:, 0:9], rows)
    return np.asarray(vjp(jnp.asarray(ct, jnp.float32))[0])


def _within_rule(got, want, abs_sum):
    err = np.abs(np.asarray(got, np.float64) - want)
    return bool((err <= 1e-5 * abs_sum).all()), float((err / np.maximum(abs_sum, 1e-30)).max())


def _check_scatter(so, idx, ct, n_tris):
    counters = torch.zeros(len(cuda_scatter.COUNTERS), dtype=torch.int64)
    got = torch_host_build.corner_scatter(so, torch.as_tensor(ct), torch.as_tensor(idx), n_tris,
                                          counters)
    plain = cuda_scatter.corner_scatter_torch(torch.as_tensor(ct), torch.as_tensor(idx), n_tris)
    want = np.zeros((n_tris, 9))
    abs_sum = np.zeros((n_tris, 9))
    np.add.at(want, idx, ct.astype(np.float64))
    np.add.at(abs_sum, idx, np.abs(ct.astype(np.float64)))
    from_jax = _jax_scatter(idx, ct, n_tris)
    assert got.shape == (n_tris, 10) and got.dtype == torch.float32
    assert not got[:, 9].any() and not from_jax[:, 9].any()
    for ref, what in ((want, "float64"), (plain[:, :9].numpy().astype(np.float64), "plain"),
                      (from_jax[:, :9].astype(np.float64), "jax")):
        ok, worst = _within_rule(got[:, :9].numpy(), ref, abs_sum)
        assert ok, f"against {what}: worst {worst:.3e} of the terms' absolute sum"
    counts = np.bincount(idx)
    assert dict(zip(cuda_scatter.COUNTERS, counters.tolist())) == {
        "launches": 1, "rows": idx.shape[0], "rows_nonzero": int((ct != 0).any(1).sum()),
        "segments": int((counts > 0).sum()), "longest_rows": int(counts.max())}
    return got


@pytest.mark.parametrize("name", CASES)
def test_scatter_host_build_matches_float64_and_plain(so, name):
    idx, ct = _case(name)
    _check_scatter(so, idx, ct, T)


def test_scatter_host_build_on_a_mixed_frame_s_ids(so):
    """A 48x27 `mixed` frame's triangle ids, clamped as the shade clamps
    them (misses to 0), with the shade backward's corner cotangent for a
    seeded image cotangent (zero on the misses)."""
    scene, cfg, method, o, d, res, corners = torch_host_build.case("mixed", False,
                                                                   dict(shadow="hard"))
    from tpu_ray_torch.kernels import cuda_shade

    n_tris = scene.mesh.num_tris
    idx = torch.clamp(res["mesh_tri"], 0, n_tris - 1)
    ct = torch.as_tensor(np.random.default_rng(0).standard_normal((o.shape[0], 3), np.float32))
    d_corners = cuda_shade.shade_bwd_torch(scene, cfg, o, d, res, corners, ct,
                                           method)["corners"].contiguous()
    assert not d_corners[~res["mesh_hit"]].any() and d_corners.any()
    _check_scatter(so, idx.numpy(), d_corners.numpy(), n_tris)


def test_scatter_host_build_is_bit_identical_across_calls(so):
    idx, ct = _case("runs_and_singletons")
    a = torch_host_build.corner_scatter(so, torch.as_tensor(ct), torch.as_tensor(idx), T)
    b = torch_host_build.corner_scatter(so, torch.as_tensor(ct), torch.as_tensor(idx), T)
    assert torch.equal(a, b)


def test_gather_host_build_equals_indexing(so):
    rng = np.random.default_rng(1)
    rows = torch.as_tensor(rng.standard_normal((T, 10), np.float32))
    idx = torch.as_tensor(rng.integers(0, T, 5_000), dtype=torch.int32)
    got = torch_host_build.corner_gather(so, rows, idx)
    assert torch.equal(got, rows[idx.long()][:, :9])
    assert torch.equal(got, cuda_scatter.corner_gather_torch(rows, idx))


def test_cpu_tensors_take_the_plain_path():
    rng = np.random.default_rng(2)
    rows = torch.as_tensor(rng.standard_normal((500, 10), np.float32)).requires_grad_(True)
    idx = torch.as_tensor(rng.integers(0, 500, 3_000), dtype=torch.int32)
    ct = torch.as_tensor(rng.standard_normal((3_000, 9), np.float32))
    before = dict(cuda_scatter.LAUNCHES)
    corners = cuda_scatter.corner_gather(rows, idx)
    (grad,) = torch.autograd.grad(corners, rows, ct)
    assert torch.equal(corners, rows[idx.long()][:, :9])
    want = torch.autograd.grad(rows[idx.long()][:, :9].contiguous(), rows, ct)[0]
    assert torch.equal(grad, want)
    assert torch.equal(cuda_scatter.corner_scatter(ct, idx, 500), want)
    assert cuda_scatter.LAUNCHES == before
    assert dict(cuda_scatter.scatter_counters()) == {}


def test_the_shade_s_gather_clamps_its_ids_and_reads_no_range(monkeypatch):
    """shade_corners clamps a miss's -1 (and any id past the table) into
    [0, T) as the shade wants, then gathers as corner_gather does; it never
    reads the ids' range (no wait for the device on the card)."""
    rng = np.random.default_rng(3)
    rows = torch.as_tensor(rng.standard_normal((500, 10), np.float32)).requires_grad_(True)
    tri = torch.as_tensor(rng.integers(-1, 505, 3_000), dtype=torch.int32)
    ct = torch.as_tensor(rng.standard_normal((3_000, 9), np.float32))

    def no_range(*_):
        raise AssertionError("the shade's gather read the ids' range")

    monkeypatch.setattr(cuda_scatter, "_check_range", no_range)
    corners = cuda_scatter.shade_corners(rows, tri)
    clamped = tri.clamp(0, 499).long()
    assert torch.equal(corners, rows[clamped][:, :9])
    (grad,) = torch.autograd.grad(corners, rows, ct)
    want = np.zeros((500, 10), np.float64)
    np.add.at(want[:, :9], clamped.numpy(), ct.numpy().astype(np.float64))
    assert np.allclose(grad.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("fault", ["float64_rows", "non_contiguous_rows", "not_a_table",
                                   "int16_ids", "non_contiguous_ids", "id_below_0",
                                   "id_past_the_table"])
def test_the_wrapper_refuses_what_the_kernels_do_not_take(fault):
    rows = torch.zeros((100, 10))
    idx = torch.arange(50, dtype=torch.int32)
    error = {"float64_rows": TypeError, "int16_ids": TypeError, "id_below_0": IndexError,
             "id_past_the_table": IndexError}.get(fault, ValueError)
    if fault == "float64_rows":
        rows = rows.double()
    elif fault == "non_contiguous_rows":
        rows = torch.zeros((10, 100)).T
    elif fault == "not_a_table":
        rows = torch.zeros((100, 9))
    elif fault == "int16_ids":
        idx = idx.to(torch.int16)
    elif fault == "non_contiguous_ids":
        idx = torch.arange(100, dtype=torch.int32)[::2]
    elif fault == "id_below_0":
        idx[7] = -1
    else:
        idx[7] = 100
    with pytest.raises(error):
        cuda_scatter.check_inputs(rows, idx)
