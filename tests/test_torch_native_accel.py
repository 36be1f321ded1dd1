"""The port's native packet-accel builder (tpu_ray_torch/native) and the disk
cache of accel/packet.build_packet_parts.

  * the native build equals the port's numpy build bit for bit (corners,
    both box arrays, perm, with and without tri_id_base, and the parts of
    a split mesh), and the reference's build (tpu_ray.accel.packet);
  * a compile that fails, or a library of another ABI tag, raises: the port
    never falls back silently; TPU_RAY_TORCH_NATIVE=0 alone picks numpy;
  * the cache round-trips the parts, keys on the budget and `streamed`,
    ignores a corrupt file and never stops a build it cannot write;
  * `knot8m`: one whole-mesh part of the reference's size, equal to the
    reference's accel by a SHA-1 of each array (a full compare would hold
    two more ~0.6 GB copies).
"""

import hashlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tpu_ray.accel.packet as jpk
from tpu_ray_torch import native
from tpu_ray_torch.accel import packet as pk
from tpu_ray_torch.scene.mesh import torus_knot

FIELDS = ("corners", "chunk_aabb", "super_aabb", "perm")


@pytest.fixture
def cache(tmp_path, monkeypatch):
    d = tmp_path / "accel_cache"
    monkeypatch.setenv(pk.CACHE_ENV, str(d))
    return d


def _numpy(monkeypatch):
    monkeypatch.setenv(native.ENV_SWITCH, "0")


def _assert_bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
            assert a.numpy().dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
        assert g.num_tris == w.num_tris


@pytest.mark.parametrize("knot", [(2, 3, 37, 21), (2, 3, 128, 100), (3, 5, 200, 160)],
                         ids=["1554-pad-heavy", "25600", "64000"])
def test_native_build_bit_equals_numpy_and_jax(monkeypatch, knot):
    v, f = torus_knot(*knot)
    got = pk.build_packet_accel(v, f)
    with monkeypatch.context() as m:
        _numpy(m)
        want = pk.build_packet_accel(v, f)
    _assert_bit_equal([got], [want])
    _assert_bit_equal([got], [jpk.build_packet_accel(v, f)])


def test_native_build_with_tri_id_base(monkeypatch):
    v, f = torus_knot(2, 3, 64, 48)
    base = np.arange(f.shape[0])[::-1].copy()  # non-identity original ids
    got = pk.build_packet_accel(v, f, tri_id_base=base)
    with monkeypatch.context() as m:
        _numpy(m)
        want = pk.build_packet_accel(v, f, tri_id_base=base)
    _assert_bit_equal([got], [want])
    _assert_bit_equal([got], [jpk.build_packet_accel(v, f, tri_id_base=base)])


def test_native_split_parts_bit_equal_numpy(monkeypatch):
    v, f = torus_knot(2, 3, 160, 120)  # 38,400 triangles
    budget = pk.packet_accel_bytes(pk.CHUNK * pk.SUPER * 4)
    got = pk.build_packet_parts(v, f, budget_bytes=budget, streamed=False, device="cpu")
    with monkeypatch.context() as m:
        _numpy(m)
        want = pk.build_packet_parts(v, f, budget_bytes=budget, streamed=False, device="cpu")
    assert len(got) > 1
    _assert_bit_equal(got, want)
    _assert_bit_equal(got, jpk.build_packet_parts(v, f, budget_bytes=budget, streamed=False))


def test_numpy_switch_never_loads_the_library(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the native builder ran under TPU_RAY_TORCH_NATIVE=0")

    monkeypatch.setattr(native, "build_accel", refuse)
    v, f = torus_knot(2, 3, 20, 10)
    for value in ("0", "off", "false"):
        monkeypatch.setenv(native.ENV_SWITCH, value)
        assert not native.enabled()
        assert pk.build_packet_accel(v, f).num_tris == f.shape[0]
    monkeypatch.setenv(native.ENV_SWITCH, "1")
    with pytest.raises(AssertionError, match="native builder ran"):
        pk.build_packet_accel(v, f)


def test_failed_compile_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int tpu_ray_accel_abi(void) { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.compile_library(bad, tmp_path / "broken.so")
    assert not (tmp_path / "broken.so").exists()
    assert not list(tmp_path.glob("*.tmp"))
    # and through the builder: no numpy fallback
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    v, f = torus_knot(2, 3, 20, 10)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pk.build_packet_accel(v, f)


def test_other_abi_tag_raises(tmp_path):
    src = tmp_path / "other.cpp"
    src.write_text('#include <cstdint>\nextern "C" int64_t tpu_ray_accel_abi(void) '
                   '{ return 42; }\n')
    so = native.compile_library(src, tmp_path / "other.so")
    with pytest.raises(RuntimeError, match="ABI tag 42"):
        native.load_library(so)


def test_library_is_keyed_by_source_and_abi(tmp_path):
    a = tmp_path / "a.cpp"
    a.write_text(native.SRC.read_text())
    b = tmp_path / "b.cpp"
    b.write_text(native.SRC.read_text() + "\n// another build\n")
    assert native.library_path(a) == native.library_path(native.SRC)
    assert native.library_path(b) != native.library_path(a)
    assert native.library_path(a).parent == native.BUILD_DIR


def _big_mesh():
    return torus_knot(2, 3, 250, 200)  # 100,000 triangles: the cache's threshold


def test_cache_round_trips(cache, monkeypatch):
    v, f = _big_mesh()
    assert f.shape[0] >= pk.CACHE_MIN_TRIS
    first = pk.build_packet_parts(v, f, device="cpu")
    files = list(cache.glob("accel_*.npz"))
    assert len(files) == 1 and not list(cache.glob("*.tmp"))
    monkeypatch.setattr(pk, "_build_parts", lambda *a: pytest.fail("cache not read"))
    _assert_bit_equal(pk.build_packet_parts(v, f, device="cpu"), first)
    # another budget or streamed setting is another entry
    monkeypatch.undo()
    monkeypatch.setenv(pk.CACHE_ENV, str(cache))
    pk.build_packet_parts(v, f, streamed=True, device="cpu")
    assert len(list(cache.glob("accel_*.npz"))) == 2


@pytest.mark.parametrize("damage", ["garbage", "truncated", "empty"])
def test_cache_ignores_a_corrupt_file_and_small_meshes(cache, damage):
    v, f = _big_mesh()
    want = pk.build_packet_parts(v, f, device="cpu")
    (path,) = cache.glob("accel_*.npz")
    size = path.stat().st_size
    data = path.read_bytes()
    path.write_bytes({"garbage": b"not an npz", "truncated": data[:len(data) // 2],
                      "empty": b""}[damage])
    _assert_bit_equal(pk.build_packet_parts(v, f, device="cpu"), want)
    assert path.stat().st_size == size  # rebuilt and written anew
    sv, sf = torus_knot(2, 3, 20, 10)
    pk.build_packet_parts(sv, sf, device="cpu")
    assert len(list(cache.glob("accel_*.npz"))) == 1


def test_unwritable_cache_never_blocks_a_build(tmp_path, monkeypatch):
    """A cache path under a regular file cannot be created, whoever runs."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv(pk.CACHE_ENV, str(blocker / "cache"))
    v, f = _big_mesh()
    assert pk.build_packet_parts(v, f, device="cpu")[0].num_tris == f.shape[0]
    monkeypatch.setenv(pk.CACHE_ENV, "")  # "" turns the cache off
    assert pk.cache_dir() == ""
    assert pk.build_packet_parts(v, f, device="cpu")[0].num_tris == f.shape[0]


def _digest(a) -> str:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_knot8m_accel_matches_jax():
    """The registry's `knot8m`: 8,388,610 triangles in one whole-mesh part
    below TRI_SLOT_LIMIT (65,537 chunks padded to 65,552, 4,097 supers),
    equal to the reference's accel array by array."""
    from tpu_ray.scene import scenes as jscenes
    from tpu_ray_torch.scene import scenes as tscenes

    scene, cfg = tscenes.build_scene("knot8m", device="cpu")
    assert scene.mesh.num_tris == 2048 * 2048 * 2 + 2 and scene.grid is None
    (a,) = scene.packet
    assert a.perm.shape[0] == 8_388_736 < pk.TRI_SLOT_LIMIT
    assert a.chunk_aabb.shape[0] == 65_552 and a.super_aabb.shape[0] == 4_097
    assert a.corners.shape == (65_552 * 16, 128)
    own = {f: _digest(getattr(a, f)) for f in FIELDS}
    del scene, a
    jscene, jcfg = jscenes.build_scene("knot8m", dtype=jnp.float32)
    (ja,) = jscene.packet
    assert own == {f: _digest(getattr(ja, f)) for f in FIELDS}
    assert (cfg.width, cfg.height, cfg.block_size) == (jcfg.width, jcfg.height, jcfg.block_size)
