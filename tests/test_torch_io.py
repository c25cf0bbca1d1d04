"""Port parity: zarr stores, history, geometry, checkpoints, regrid and
logging.

* ``jaxstream_torch.io.zarrlite`` passes the golden zarr-v2 fixture,
  byte for byte.
* Fed the same numpy state, the two packages' history and geometry
  stores are byte-equal (file list and bytes), and each package reads
  the other's.
* The torch-native ``CheckpointManager``: round trip, retention, meta,
  members, atomic saves, and states crossing the packages through
  ``restore_host``.
* ``regrid_state`` equals the JAX package's to <= 1e-12 at float64.
"""

import logging
import os

import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

import jax.numpy as jnp

from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.io import regrid as jregrid
from jaxstream.io.checkpoint import CheckpointManager as JaxCkpt
from jaxstream.io.history import HistoryWriter as JaxHist
from jaxstream.io.history import save_geometry as jax_save_geometry

from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.io import regrid as tregrid
from jaxstream_torch.io.checkpoint import CheckpointManager
from jaxstream_torch.io.history import (HistoryWriter, extract_member,
                                        geometry_matches,
                                        load_geometry_arrays, member_axis,
                                        save_geometry)
from jaxstream_torch.io.zarrlite import ZarrGroup, open_group
from jaxstream_torch.utils import logging as tlog

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "golden_zarr_v2")


def _listing(root, skip=()):
    out = {}
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        for f in files:
            if f not in skip:
                out[os.path.normpath(os.path.join(rel, f))] = os.path.join(
                    dirpath, f)
    return out


def _assert_trees_byte_equal(a, b, skip=()):
    la, lb = _listing(a, skip), _listing(b, skip)
    assert sorted(la) == sorted(lb)
    for rel in la:
        assert open(la[rel], "rb").read() == open(lb[rel], "rb").read(), rel


def _state(seed=0, n=4, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"h": rng.standard_normal((6, n, n)).astype(dtype),
            "u": rng.standard_normal((2, 6, n, n)).astype(dtype)}


# -- zarrlite -----------------------------------------------------------------

def test_zarr_golden_fixture(tmp_path):
    g = open_group(GOLDEN)
    assert g.attrs == {"step": 7, "title": "golden"}
    expect_h = (np.arange(2 * 3 * 5, dtype="<f4").reshape(2, 3, 5) * 0.5
                + 1000.0)
    np.testing.assert_array_equal(g["h"].read(), expect_h)
    np.testing.assert_array_equal(g["time"].read(), [0.0, 600.0])
    np.testing.assert_array_equal(g["count"].read(), np.arange(4))
    p = str(tmp_path / "rewrite")
    g2 = ZarrGroup.create(p, {"step": 7, "title": "golden"})
    g2.create_array("h", (2, 3, 5), "<f4", (1, 3, 2)).write_full(expect_h)
    g2.create_array("time", (2,), "<f8", (1,)).write_full(
        np.array([0.0, 600.0]))
    g2.create_array("count", (4,), "<i8", (3,)).write_full(np.arange(4))
    _assert_trees_byte_equal(GOLDEN, p, skip=("README.txt",))


# -- history and geometry -----------------------------------------------------

def _write_history(cls, path, states):
    w = cls(path, attrs={"model": "shallow_water_cov", "ic": "tc5",
                         "numerics": "dense", "members": 1})
    for i, s in enumerate(states):
        w.append(s, 600.0 * i)
    return w


def test_history_store_byte_equal_to_jax(tmp_path):
    states = [_state(i) for i in range(3)]
    _write_history(JaxHist, str(tmp_path / "j"), states)
    _write_history(HistoryWriter, str(tmp_path / "t"),
                   [{k: torch.from_numpy(v) for k, v in s.items()}
                    for s in states])
    _assert_trees_byte_equal(str(tmp_path / "j"), str(tmp_path / "t"))


def test_history_stores_cross_read(tmp_path):
    states = [_state(i) for i in range(2)]
    _write_history(JaxHist, str(tmp_path / "j"), states)
    _write_history(HistoryWriter, str(tmp_path / "t"), states)
    # The port reopens a JAX store and appends; JAX reopens the port's.
    tw = HistoryWriter(str(tmp_path / "j"))
    assert len(tw) == 2
    tw.append(_state(5), 1200.0)
    jw = JaxHist(str(tmp_path / "t"))
    assert len(jw) == 2
    jw.append(_state(5), 1200.0)
    _assert_trees_byte_equal(str(tmp_path / "j"), str(tmp_path / "t"))
    for k in ("h", "u"):
        np.testing.assert_array_equal(HistoryWriter(str(tmp_path / "j"))
                                      .read(k), jw.read(k))
    np.testing.assert_array_equal(tw.times, [0.0, 600.0, 1200.0])


def test_history_refuses_tt_rank(tmp_path):
    with pytest.raises(NotImplementedError, match=r"queue A item 8 \(A11\)"):
        HistoryWriter(str(tmp_path / "h"), tt_rank=4)
    JaxHist(str(tmp_path / "j"), tt_rank=2).append(
        {"h": np.ones((6, 8, 8), np.float32)}, 0.0)
    with pytest.raises(NotImplementedError, match="A11"):
        HistoryWriter(str(tmp_path / "j"))


def test_history_members_and_dangling_frames(tmp_path):
    p = str(tmp_path / "h")
    w = HistoryWriter(p, attrs={"members": 2})
    b = {"h": np.stack([_state(0)["h"], _state(1)["h"]])}
    w.append(b, 0.0)
    np.testing.assert_array_equal(w.read_member("h", 1)[0], _state(1)["h"])
    assert member_axis(np.zeros((2, 3, 6, 4, 4))) == 1
    np.testing.assert_array_equal(
        extract_member({"u": torch.zeros(2, 3, 6, 4, 4)}, 2)["u"],
        np.zeros((2, 6, 4, 4)))
    # A field slab whose time slab never landed is a dangling tail.
    w.group["h"].write_index0(1, b["h"] + 1)
    assert HistoryWriter(p).read("h").shape[0] == 1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_geometry_store_byte_equal_to_jax(tmp_path, dtype):
    g = build_grid(6, halo=2, radius=6.37122e6, dtype=getattr(torch, dtype),
                   device="cpu")
    jg = jax_build_grid(6, halo=2, radius=6.37122e6,
                        dtype=getattr(jnp, dtype))
    save_geometry(str(tmp_path / "t"), g)
    jax_save_geometry(str(tmp_path / "j"), jg)
    _assert_trees_byte_equal(str(tmp_path / "t"), str(tmp_path / "j"))
    back = load_geometry_arrays(str(tmp_path / "t"))
    assert "device" not in back and "dtype" not in back
    assert back["__attrs__"]["conventions"] == "jaxstream-geometry-1"


def test_geometry_matches_and_skips(tmp_path):
    p = str(tmp_path / "geom")
    g = build_grid(6, halo=2, device="cpu")
    jax_save_geometry(p, jax_build_grid(6, halo=2, dtype=jnp.float32))
    assert geometry_matches(p, g)          # a JAX store of the same grid
    mtime = os.path.getmtime(os.path.join(p, "xyz", "0.0.0.0"))
    save_geometry(p, g)                    # matching -> untouched
    assert os.path.getmtime(os.path.join(p, "xyz", "0.0.0.0")) == mtime
    g64 = build_grid(6, halo=2, dtype=torch.float64, device="cpu")
    assert not geometry_matches(p, g64)    # the dtype alone differs
    assert not geometry_matches(str(tmp_path / "nope"), g)
    save_geometry(p, g64)
    assert open_group(p)["xyz"].dtype == np.float64


# -- checkpoints --------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None
    s = {k: torch.from_numpy(v) for k, v in _state().items()}
    mgr.save(10, s, 6000.0)
    mgr.save(20, _state(1), np.float32(12000.0))
    assert mgr.latest_step() == 20
    restored, t = mgr.restore(device="cpu")
    assert t == 12000.0 and isinstance(t, float)
    assert isinstance(restored["h"], torch.Tensor)
    np.testing.assert_array_equal(restored["h"].numpy(), _state(1)["h"])
    host, t10 = CheckpointManager(str(tmp_path / "ckpt")).restore_host(10)
    assert t10 == 6000.0 and isinstance(host["u"], np.ndarray)
    np.testing.assert_array_equal(host["u"], _state()["u"])
    assert host["u"].dtype == np.float32
    # Saves are atomic: no temporary directory is left behind.
    assert sorted(os.listdir(str(tmp_path / "ckpt"))) == ["10", "20"]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_host()


def test_checkpoint_retention_and_overwrite(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3)
    for step in range(1, 7):
        mgr.save(step, _state(step), float(step))
    assert mgr.steps() == [4, 5, 6]
    mgr.save(6, _state(9), 66.0)
    assert mgr.steps() == [4, 5, 6]
    state, t = mgr.restore_host()
    assert t == 66.0
    np.testing.assert_array_equal(state["h"], _state(9)["h"])
    assert CheckpointManager(str(tmp_path / "d")).max_to_keep == 5


def test_checkpoint_meta_and_member(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    hb = np.stack([_state(0)["h"], _state(1)["h"]])
    mgr.save(3, {"h": hb}, 1.0, meta={"postmortem": True, "member": 1,
                                      "note": "dropped", "none": None})
    assert mgr.restore_meta() == {"postmortem": 1, "member": 1}
    m1, t = mgr.restore_member(1)
    np.testing.assert_array_equal(m1["h"], _state(1)["h"])
    mgr.save(4, _state(0), 2.0)
    assert mgr.restore_meta() == {}
    with pytest.raises(ValueError, match="not member-batched"):
        mgr.restore_member(0)


def test_checkpoints_cross_the_packages(tmp_path):
    """JAX restore_host -> port save -> port restore, and the reverse."""
    s = _state(3, n=8)
    jm = JaxCkpt(str(tmp_path / "jax"))
    jm.save(4, {k: jnp.asarray(v) for k, v in s.items()}, 2400.0)
    host, t = jm.restore_host()
    tm = CheckpointManager(str(tmp_path / "port"))
    tm.save(4, host, t)
    back, t2 = tm.restore(device="cpu")
    assert t2 == 2400.0
    for k in s:
        np.testing.assert_array_equal(back[k].numpy(), s[k])
    # The reverse: port restore_host -> JAX save -> JAX restore.
    host2, t3 = tm.restore_host()
    jm2 = JaxCkpt(str(tmp_path / "jax2"))
    jm2.save(4, host2, t3)
    out, t4 = jm2.restore_host()
    assert t4 == 2400.0
    for k in s:
        np.testing.assert_array_equal(np.asarray(out[k]), s[k])


# -- regrid -------------------------------------------------------------------

@pytest.mark.parametrize("n_old, n_new", [(8, 12), (12, 8), (8, 8)])
def test_regrid_matches_jax(n_old, n_new):
    rng = np.random.default_rng(n_old * 100 + n_new)
    s = {"h": 5000.0 + rng.standard_normal((6, n_old, n_old)),
         "u": rng.standard_normal((2, 6, n_old, n_old))}
    ours = tregrid.regrid_state({k: torch.from_numpy(v) for k, v in
                                 s.items()}, n_new, dtype=torch.float64)
    ref = jregrid.regrid_state(s, n_new, dtype=np.float64)
    for k in s:
        a, b = np.asarray(ours[k]), np.asarray(ref[k])
        assert a.shape == b.shape == s[k].shape[:-2] + (n_new, n_new)
        assert np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(b)), k
    np.testing.assert_array_equal(tregrid.overlap_matrix(n_old, n_new),
                                  jregrid.overlap_matrix(n_old, n_new))
    assert tregrid.infer_resolution(s) == n_old


def test_regrid_conserves_mass_and_refuses_mixed_shapes():
    h = 5000.0 + np.random.default_rng(0).standard_normal((6, 8, 8))
    out = tregrid.regrid_state({"h": h.astype(np.float32)}, 12)
    assert out["h"].dtype == np.float32
    a8, a12 = tregrid._areas_f64(8), tregrid._areas_f64(12)
    h64 = tregrid.regrid_state({"h": h}, 12)["h"]
    assert abs(np.sum(a12 * h64) - np.sum(a8 * h)) <= 1e-12 * np.sum(a8 * h)
    with pytest.raises(ValueError, match="single per-panel resolution"):
        tregrid.infer_resolution({"h": np.zeros((6, 8, 8)),
                                  "u": np.zeros((2, 6, 12, 12))})


# -- logging ------------------------------------------------------------------

def _record(level):
    return logging.LogRecord("jaxstream_torch.test", level, __file__, 1,
                             "msg", (), None)


@pytest.mark.parametrize("info, forced, level, passes, prefix", [
    ((0, 1), False, logging.INFO, True, ""),
    ((0, 4), False, logging.INFO, True, "p0 "),
    ((3, 4), False, logging.INFO, False, "p3 "),
    ((3, 4), False, logging.WARNING, True, "p3 "),
    ((3, 4), True, logging.INFO, True, "p3 "),
])
def test_logging_filter(monkeypatch, info, forced, level, passes, prefix):
    monkeypatch.setattr(tlog, "_process_info", lambda: info)
    rec = _record(level)
    assert tlog._MultihostFilter(forced=forced).filter(rec) is passes
    assert rec.pidx == prefix


def test_get_logger_names_and_rank_without_a_group():
    assert tlog.get_logger("simulation").name == "jaxstream_torch.simulation"
    assert tlog.get_logger("jaxstream_torch.io").name == "jaxstream_torch.io"
    root = logging.getLogger("jaxstream_torch")
    n = len(root.handlers)
    tlog.get_logger("again")
    assert len(root.handlers) == n
    assert tlog._process_info() == (0, 1)
