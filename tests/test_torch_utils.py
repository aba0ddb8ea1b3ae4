"""PyTorch port vs the JAX package: utils/ (memory, io, offload, profiling, benchtime).

- `memory.nbytes` of a frame (every attribute and aux) and of a voxel map,
  built from the same points, equal to the JAX package's (both packages
  store the same dtypes in every field);
- an npz written by either package's `save_frame_npz` loads in the other bit
  for bit;
- the readers and `load_graph` on files written here, equal to the JAX
  package's and to what was written;
- `OffloadPool` through the JAX test's LRU sequence
  (tests/test_misc_components.py:272-310) on both packages: the same flags,
  clocks, device usage and contents, and entries of every kind `nbytes`
  walks;
- `EasyProfiler`'s labels and table, `chain_marginal` on a stub chain with a
  stub clock, the same as the JAX package's; `tunnel_probe_ms` and `trace`
  on the CPU;
- the pool's caller, the endurance session's protocol
  (chip_smoke.endurance_protocol) over 9 poses with a 3-frame pool budget
  and one closure whose old keyframe comes back from the host: every pose
  within 1e-3 m and 1e-3 rad of the JAX package's, the same closure, reload
  and spill counts, the keyframe back bit for bit.
"""

import io as _io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gtsam_points_tpu.ops.voxelmap import build_voxelmap as jbuild
from gtsam_points_tpu.types.frame import make_frame as jmake
from gtsam_points_tpu.utils import benchtime as jbenchtime
from gtsam_points_tpu.utils import io as jio
from gtsam_points_tpu.utils import profiling as jprofiling
from gtsam_points_tpu.utils.memory import nbytes as jnbytes
from gtsam_points_tpu.utils.offload import OffloadPool as JPool
from gtsam_points_tpu_torch.ops.voxelmap import build_voxelmap
from gtsam_points_tpu_torch.types.frame import Frame, make_frame
from gtsam_points_tpu_torch.utils import benchtime, io, profiling
from gtsam_points_tpu_torch.utils.memory import map_tensors, nbytes, tensors
from gtsam_points_tpu_torch.utils.offload import OffloadPool
from test_torch_real_size import _pose_shift, jax_endurance_api

torch.set_num_threads(1)
POSE_TOL_M = 1e-3
POSE_TOL_RAD = 1e-3
ENDURANCE_POSES = 9
ENDURANCE_LOOPS = {8: 4}  # pose 4 frozen (window 4) and spilled (budget 3) by pose 8
ENDURANCE_WORLD_N = 8000  # a sparser ring: 2048-point scans 5.5 m apart still overlap
ENDURANCE_BUDGET = 3


def _attributes(n: int, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    a = rng.randn(n, 3, 3).astype(np.float32)
    return {"points": (rng.rand(n, 3) * 8).astype(np.float32), "normals": rng.randn(n, 3).astype(np.float32),
            "covs": (a @ a.transpose(0, 2, 1)).astype(np.float32), "intensities": rng.rand(n).astype(np.float32),
            "times": rng.rand(n).astype(np.float32), "aux": {"ring": rng.rand(n).astype(np.float32),
                                                             "rgb": rng.rand(n, 3).astype(np.float32)}}


def test_nbytes_frame_and_voxelmap_match_jax():
    att = _attributes(500, 0)
    jf, tf = jmake(**att, capacity=512), make_frame(**att, capacity=512, device="cpu")
    assert nbytes(tf) == jnbytes(jf) == 512 * (12 + 1 + 12 + 36 + 4 + 4 + 4 + 12)
    bare_j, bare_t = jmake(att["points"]), make_frame(att["points"], device="cpu")
    assert nbytes(bare_t) == jnbytes(bare_j)
    jm = jbuild(jf, 1.0, capacity=1024)
    tm = build_voxelmap(tf, 1.0, capacity=1024)
    assert nbytes(tm) == jnbytes(jm)
    for name, t in tm._asdict().items():  # field by field: the same dtypes, no wider field in the port
        j = getattr(jm, name)
        assert t.numel() * t.element_size() == j.size * j.dtype.itemsize, name
    # the walk reaches nested dicts, lists, tuples and NamedTuples
    tree = {"frames": [tf, bare_t], "maps": (tm,), "n": 3}
    assert nbytes(tree) == nbytes(tf) + nbytes(bare_t) + nbytes(tm)
    assert len(list(tensors(tree))) == len(list(tensors(tf))) + len(list(tensors(bare_t))) + len(tm)
    moved = map_tensors(lambda x: x.double() if x.is_floating_point() else x, tree)
    assert isinstance(moved["frames"][0], Frame) and moved["n"] == 3
    assert moved["frames"][0].aux["rgb"].dtype == torch.float64 and moved["maps"][0].keys.dtype == torch.int32


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_frame_npz_between_packages(tmp_path, writer):
    att = _attributes(300, 1)
    path = str(tmp_path / "frame.npz")
    jf, tf = jmake(**att), make_frame(**att, device="cpu")
    if writer == "jax":
        jio.save_frame_npz(path, jf)
    else:
        io.save_frame_npz(path, tf)
    back_t, back_j = io.load_frame_npz(path, device="cpu"), jio.load_frame_npz(path)
    for name in ("points", "mask", "normals", "covs", "intensities", "times"):
        src = np.asarray(getattr(jf, name))
        assert getattr(back_t, name).numpy().tobytes() == src.tobytes(), name
        assert getattr(back_t, name).numpy().dtype == src.dtype, name
        assert np.asarray(getattr(back_j, name)).tobytes() == src.tobytes(), name
    assert sorted(back_t.aux) == sorted(back_j.aux) == ["rgb", "ring"]
    for k in back_t.aux:
        assert back_t.aux[k].numpy().tobytes() == np.asarray(back_j.aux[k]).tobytes() == np.asarray(jf.aux[k]).tobytes()
    bare = str(tmp_path / "bare.npz")
    io.save_frame_npz(bare, make_frame(att["points"], device="cpu"))
    assert io.load_frame_npz(bare, device="cpu").aux is None and jio.load_frame_npz(bare).normals is None


def test_data_root_reads_only_the_variable(monkeypatch, tmp_path):
    monkeypatch.setenv("GTSAM_POINTS_DATA", str(tmp_path))
    assert io.data_root() == str(tmp_path)
    monkeypatch.delenv("GTSAM_POINTS_DATA")
    with pytest.raises(RuntimeError, match="GTSAM_POINTS_DATA"):
        io.data_root()


def test_readers_and_graph(tmp_path):
    rng = np.random.RandomState(2)
    xyz = rng.randn(1000, 3).astype(np.float32)
    xyzi = rng.randn(800, 4).astype(np.float32)
    times = rng.rand(1000).astype(np.float32)
    xyz.tofile(tmp_path / "points.bin")
    xyzi.tofile(tmp_path / "velo.bin")
    times.tofile(tmp_path / "times.bin")
    rows = np.concatenate([rng.randn(6, 3), rng.randn(6, 4)], 1)
    order = [3, 0, 5, 1, 4, 2]
    with open(tmp_path / "graph.txt", "w") as f:
        f.write("# a comment line\n")
        for i in order:  # out of order: sorted by vertex id
            f.write(f"v{i} " + " ".join(repr(float(x)) for x in rows[i]) + "\n")
        f.write("e0 1 0 0 0 0 0 0 1\n")
    p = str(tmp_path)
    for name, port, ref in (("read_points", io.read_points(p + "/points.bin"), xyz),
                            ("read_points4", io.read_points4(p + "/velo.bin"), xyzi),
                            ("read_times", io.read_times(p + "/times.bin"), times),
                            ("load_graph", io.load_graph(p + "/graph.txt"), rows.astype(np.float32))):
        jax_out = getattr(jio, name)(p + ("/graph.txt" if name == "load_graph" else {
            "read_points": "/points.bin", "read_points4": "/velo.bin", "read_times": "/times.bin"}[name]))
        assert port.dtype == jax_out.dtype == np.float32 and port.tobytes() == jax_out.tobytes() == ref.tobytes(), name
    pts, inten = io.read_kitti_bin(p + "/velo.bin")
    jpts, jinten = jio.read_kitti_bin(p + "/velo.bin")
    assert pts.tobytes() == jpts.tobytes() == np.ascontiguousarray(xyzi[:, :3]).tobytes()
    assert inten.tobytes() == jinten.tobytes() == np.ascontiguousarray(xyzi[:, 3]).tobytes()
    assert pts.flags.c_contiguous and inten.flags.c_contiguous


def _snapshot(pool, names) -> dict:
    return {"clock": pool.current_access_time(), "usage": pool.memory_usage_device(), "names": pool.names(),
            "on": [pool.loaded_on_device(n) for n in names], "last": [pool.last_accessed_time(n) for n in names]}


def test_offload_pool_lru_matches_jax():
    """The JAX test's LRU sequence on both packages, snapshot after every step."""
    rng = np.random.RandomState(5)
    clouds = [(rng.rand(512, 3) * 8).astype(np.float32) for _ in range(3)]
    jmaps = {f"m{i}": jbuild(jmake(c, capacity=512), 1.0) for i, c in enumerate(clouds)}
    tmaps = {f"m{i}": build_voxelmap(make_frame(c, capacity=512, device="cpu"), 1.0) for i, c in enumerate(clouds)}
    per = jnbytes(jmaps["m0"])
    assert nbytes(tmaps["m0"]) == per
    pools = {"jax": JPool(device_budget_bytes=int(per * 2.5)),
             "torch": OffloadPool(device_budget_bytes=int(per * 2.5), device="cpu")}
    maps = {"jax": jmaps, "torch": tmaps}
    names = ["m0", "m1", "m2"]
    history = []
    steps = [("put", "m0"), ("put", "m1"), ("put", "m2"), ("touch", "m0"), ("offload", "m2"), ("offload", "m2"),
             ("reload", "m2"), ("reload", "m2"), ("ensure_budget", None), ("touch", "m1"), ("remove", "m0")]
    for op, name in steps:
        out = {}
        for pkg, pool in pools.items():
            if op == "put":
                out[pkg] = pool.put(name, maps[pkg][name])
            elif op == "ensure_budget":
                out[pkg] = pool.ensure_budget()
            else:
                out[pkg] = getattr(pool, op)(name)
        if op in ("offload", "reload", "ensure_budget"):
            assert out["jax"] == out["torch"], (op, name)
        if op == "touch":
            for field, t in out["torch"]._asdict().items():
                assert t.numpy().tobytes() == np.asarray(getattr(out["jax"], field)).tobytes(), field
                assert t.numpy().tobytes() == getattr(tmaps[name], field).numpy().tobytes(), field
        live = [n for n in names if n in pools["jax"].names()]
        history.append(_snapshot(pools["torch"], live))
        assert history[-1] == _snapshot(pools["jax"], live), (op, name)
        assert pools["torch"].memory_usage_device() <= pools["torch"].budget
    # JAX's assertions, on the port: put m2 spilled m0; touching m0 brought it back and spilled m1
    assert history[2]["on"] == [False, True, True] and history[3]["on"] == [True, False, True]


def test_offload_pool_entries_of_every_kind():
    """A frame, a voxel map and a dict of tensors spill and come back with
    their types, fields and bits; the budget holds after every put and
    touch, the exempt entry stays."""
    att = _attributes(200, 3)
    entries = {"frame": make_frame(**att, capacity=256, device="cpu"),
               "map": build_voxelmap(make_frame(att["points"], device="cpu"), 1.0),
               "dict": {"a": torch.arange(100, dtype=torch.float32), "b": [torch.ones(3, 3)]}}
    sizes = {k: nbytes(v) for k, v in entries.items()}
    pool = OffloadPool(max(sizes.values()) + 1, device="cpu")
    for k, v in entries.items():
        pool.put(k, v)
        assert pool.memory_usage_device() <= pool.budget
    assert [pool.loaded_on_device(k) for k in entries] == [False, False, True]
    for k, v in entries.items():
        back = pool.touch(k)
        assert pool.memory_usage_device() <= pool.budget and pool.loaded_on_device(k)
        assert type(back) is type(v)
        assert all(a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes()  # the probe table holds NaN bits
                   for a, b in zip(tensors(back), tensors(v)))
    assert pool.ensure_budget(exempt="dict") == 0


def test_easy_profiler_matches_jax():
    outs = {}
    for pkg, mod, x in (("jax", jprofiling, jnp.ones(3)), ("torch", profiling, torch.ones(3))):
        buf = _io.StringIO()
        with mod.EasyProfiler("slice", out=buf) as prof:
            prof.push("preprocess", block_on=x)
            prof.push("optimize", block_on={"poses": x})
        outs[pkg] = ([label for label, _ in prof.marks], [line.split(":")[0] for line in buf.getvalue().splitlines()])
        off = mod.EasyProfiler("off", enabled=False, out=buf)
        with off:
            off.push("x")
        assert off.marks == []
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == ["begin", "preprocess", "optimize", "end"]


def test_chain_marginal_and_probe(monkeypatch, tmp_path):
    """A stub chain on a stub clock: 2 s fixed + 0.5 s a unit, with the
    slowest trial cut by the median; both packages give the same pair."""
    results = {}
    for pkg, mod in (("jax", jbenchtime), ("torch", benchtime)):
        clock = {"t": 0.0, "trial": 0}
        monkeypatch.setattr(mod.time, "perf_counter", lambda: clock["t"])

        def run_chain(k):
            clock["trial"] += 1
            clock["t"] += 2.0 + 0.5 * k + (5.0 if clock["trial"] % 5 == 0 else 0.0)

        results[pkg] = mod.chain_marginal(run_chain, 4, 12, trials=5)
        monkeypatch.undo()
    assert results["torch"] == results["jax"] == pytest.approx((0.5, 8.0 / 12))
    assert benchtime.tunnel_probe_ms(trials=3, chain=4, device="cpu") > 0.0
    with profiling.trace(str(tmp_path), device="cpu"):
        torch.ones(8, 128).add(1.0)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("add" in str(e.get("name", "")) for e in events)


def test_endurance_small_matches_jax():
    kw = dict(n_poses=ENDURANCE_POSES, loops=ENDURANCE_LOOPS, world_n=ENDURANCE_WORLD_N,
              budget_frames=ENDURANCE_BUDGET)
    j = chip_smoke.endurance_protocol(jax_endurance_api(), **kw)
    t = chip_smoke.endurance_protocol(chip_smoke.port_endurance_api(torch, "cpu"), **kw)
    gap_m, gap_rad = _pose_shift(j["est"], t["est"])
    assert gap_m.max() < POSE_TOL_M and gap_rad.max() < POSE_TOL_RAD, (gap_m, gap_rad)
    assert (t["relaxes"], t["reloads"], t["spilled"]) == (j["relaxes"], j["reloads"], j["spilled"]) == (
        1, 1, ENDURANCE_POSES - ENDURANCE_BUDGET)
    assert t["frame_bytes"] == j["frame_bytes"]
    (put, back), = t["closures"].values()
    assert all(put[k].tobytes() == back[k].tobytes() for k in put)
    rot, trans = chip_smoke.endurance_ate(t["T_true"], t["est"])
    assert rot < chip_smoke.ENDURANCE_ROT_TOL and trans < chip_smoke.ENDURANCE_TRANS_TOL
