"""Persistence in the port (``fluid/io.py``, the host IO ops) against the
JAX package on the CPU.

* The wire format is the reference's byte for byte: a tensor file, a
  framed byte string and a combine file of float32, int32, int8,
  bfloat16 and a SeqArray hold the same bytes from both packages, and
  each package loads the other's with equal values and dtypes (bf16:
  equal bits; the port reads and writes it without ``ml_dtypes``, as a
  CPU ``torch.bfloat16`` tensor).
* The file rules: a flipped byte, a torn file and an unknown magic raise
  ``CheckpointCorrupt`` in both packages; a write leaves no temporary
  file behind, also when it fails.
* ``save_inference_model`` of the same script writes the same
  ``__model__`` and parameter files; each package's artifact loads and
  runs in the other to the same outputs; ``merge_inference_model`` and
  the versioned layout (publish, list, ``CURRENT``) are the same bytes.
* The host IO ops (``save``, ``load`` and their combine forms) run
  outside the step as in the reference: before it, after it, alone, and
  one between compute ops raises in both.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import io as jio
from paddle_tpu.fluid.core.lod import SeqArray as JSeq
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.fluid.core.lod import SeqArray as TSeq

CPU = tfluid.CPUPlace()
PKG = {"jax": (jfluid, jio), "port": (tfluid, tio)}


def _arrays():
    """Seeded values of each dtype a scope holds, as numpy (bf16: the
    ml_dtypes array the reference holds)."""
    rng = np.random.RandomState(3)
    return {
        "float32": rng.randn(3, 5).astype(np.float32),
        "int32": rng.randint(-9, 9, (4,)).astype(np.int32),
        "int8": rng.randint(-127, 128, (2, 3, 2)).astype(np.int8),
        "bfloat16": rng.randn(2, 7).astype(ml_dtypes.bfloat16),
        "scalar": np.array(2.5, np.float32),
        "seq": (rng.randn(3, 4, 2).astype(np.float32),
                np.array([4, 1, 3], np.int32)),
    }


def _as_port(a):
    """The port's scope value for a reference value."""
    if isinstance(a, tuple):
        return TSeq(torch.from_numpy(a[0].copy()), torch.from_numpy(a[1]))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _as_ref(a):
    return JSeq(*a) if isinstance(a, tuple) else a


def _bits(v):
    """A loaded value as numpy with bf16 as its int16 patterns."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy(), "bfloat16"
        return v.numpy(), v.numpy().dtype.name
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16), "bfloat16"
    return a, a.dtype.name


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, (JSeq, TSeq))
        _same(got.data, want[0])
        _same(got.lengths, want[1])
        return
    gb, gd = _bits(got)
    wb, wd = _bits(want)
    assert gd == wd, (gd, wd)
    assert gb.shape == wb.shape
    np.testing.assert_array_equal(gb, wb)


@pytest.mark.parametrize("kind", sorted(_arrays()))
def test_tensor_bytes_are_the_references(kind, tmp_path):
    a = _arrays()[kind]
    want = jio.tensor_to_bytes(_as_ref(a))
    got = tio.tensor_to_bytes(_as_port(a))
    assert got == want
    # the port also takes a reference value (a numpy / ml_dtypes array)
    if not isinstance(a, tuple):
        assert tio.tensor_to_bytes(a) == want
    _same(tio.tensor_from_bytes(want), a)
    _same(jio.tensor_from_bytes(got), a)
    # files: written by one, read by the other
    tio.save_tensor(_as_port(a), str(tmp_path / "t"))
    jio.save_tensor(_as_ref(a), str(tmp_path / "j"))
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    _same(tio.load_tensor(str(tmp_path / "j")), a)
    _same(jio.load_tensor(str(tmp_path / "t")), a)
    assert sorted(os.listdir(tmp_path)) == ["j", "t"]


def test_combine_file_is_the_references(tmp_path):
    arrays = _arrays()
    tio.save_tensors({k: _as_port(v) for k, v in arrays.items()},
                     str(tmp_path / "t"))
    jio.save_tensors({k: _as_ref(v) for k, v in arrays.items()},
                     str(tmp_path / "j"))
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    for loaded in (tio.load_tensors(str(tmp_path / "j")),
                   jio.load_tensors(str(tmp_path / "t"))):
        assert sorted(loaded) == sorted(arrays)
        for k, v in arrays.items():
            _same(loaded[k], v)


def _corrupt(buf, how):
    if how == "flip":
        b = bytearray(buf)
        b[len(b) // 2] ^= 0x10
        return bytes(b)
    if how == "torn":
        return buf[: len(buf) // 2]
    return b"NOTPDT" + buf[6:]


@pytest.mark.parametrize("how", ["flip", "torn", "magic"])
def test_a_corrupt_file_raises_in_both_packages(how, tmp_path):
    path = str(tmp_path / "w")
    tio.save_tensor(_as_port(_arrays()["float32"]), path)
    with open(path, "rb") as f:
        buf = f.read()
    with open(path, "wb") as f:
        f.write(_corrupt(buf, how))
    with pytest.raises(tio.CheckpointCorrupt):
        tio.load_tensor(path)
    with pytest.raises(jio.CheckpointCorrupt):
        jio.load_tensor(path)
    # the legacy unchecked magic passes through both alike
    legacy = jio._MAGIC + jio.unframe_bytes(buf)
    _same(tio.tensor_from_bytes(legacy), _arrays()["float32"])


def test_a_failed_write_leaves_no_temporary_file(tmp_path, monkeypatch):
    path = str(tmp_path / "w")
    tio.save_tensor(_as_port(_arrays()["int8"]), path)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError, match="disk full"):
        tio.save_tensor(_as_port(_arrays()["float32"]), path)
    assert os.listdir(tmp_path) == ["w"]
    _same(tio.load_tensor(path), _arrays()["int8"])


def _mlp(fluid):
    """x [8] -> fc 16 relu -> fc 4 softmax, and its Adam training."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8], "float32")
        y = fluid.layers.data("y", [1], "int64")
        h = fluid.layers.fc(x, size=16, act="relu")
        pred = fluid.layers.fc(h, size=4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, pred, loss


def _jax_state():
    main, startup, pred, loss = _mlp(jfluid)
    scope, exe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
    return {n: np.asarray(v) for n, v in scope.vars.items()
            if v is not None}


def _feed(i=0, n=5):
    rng = np.random.RandomState(40 + i)
    return {"x": rng.randn(n, 8).astype(np.float32),
            "y": rng.randint(0, 4, (n, 1)).astype(np.int64)}


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def _saved(pkg, state, dirname):
    fluid, io = PKG[pkg]
    main, _, pred, _ = _mlp(fluid)
    if pkg == "jax":
        scope, exe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
        for n, v in state.items():
            scope.set_var(n, v)
    else:
        scope, exe = tfluid.scope_from_numpy(state, CPU), tfluid.Executor(CPU)
    io.save_inference_model(str(dirname), ["x"], [pred], exe,
                            main_program=main, scope=scope)
    return main, pred


def _infer(pkg, dirname, x):
    fluid, io = PKG[pkg]
    place = jfluid.CPUPlace() if pkg == "jax" else CPU
    exe, scope = fluid.Executor(place), fluid.Scope()
    prog, feeds, fetches = io.load_inference_model(str(dirname), exe,
                                                   scope=scope)
    assert feeds == ["x"] and len(fetches) == 1
    with fluid.scope_guard(scope):
        out, = exe.run(prog, feed={"x": x}, fetch_list=fetches,
                       mode="infer")
    return np.asarray(out)


def test_inference_model_files_are_the_references_and_cross_load(tmp_path):
    state = _jax_state()
    _saved("jax", state, tmp_path / "j")
    _saved("port", state, tmp_path / "t")
    want = _files(tmp_path / "j")
    assert _files(tmp_path / "t") == want
    assert "__model__" in want and len(want) >= 5
    x = _feed()["x"]
    ref = _infer("jax", tmp_path / "j", x)
    for pkg, d in (("port", "j"), ("port", "t"), ("jax", "t")):
        np.testing.assert_allclose(_infer(pkg, tmp_path / d, x), ref,
                                   rtol=1e-6, atol=1e-7, err_msg=pkg + d)
    # the merged container: the same bytes
    tio.merge_inference_model(str(tmp_path / "t"), str(tmp_path / "t.mrg"))
    jio.merge_inference_model(str(tmp_path / "j"), str(tmp_path / "j.mrg"))
    assert (tmp_path / "t.mrg").read_bytes() == \
        (tmp_path / "j.mrg").read_bytes()
    with pytest.raises(ValueError, match="__model__"):
        tio.merge_inference_model(str(tmp_path), str(tmp_path / "x.mrg"))


def test_load_inference_model_to_device_puts_host_values():
    """On the CPU, ``device_put_persistables`` makes every host value a
    tensor and counts them; a tensor already there counts nothing."""
    state = _jax_state()
    scope = tfluid.Scope()
    for n, v in state.items():
        scope.set_var(n, v)
    main, _, _, _ = _mlp(tfluid)
    n = tio.device_put_persistables(scope, main, device="cpu")
    assert n == len([v for v in main.list_vars() if v.persistable
                     and v.name in state])
    assert all(isinstance(scope.find_var(k), torch.Tensor) for k in state)
    assert tio.device_put_persistables(scope, main, device="cpu") == 0


def test_versioned_layout_is_the_references(tmp_path):
    state = _jax_state()
    for pkg in ("jax", "port"):
        fluid, io = PKG[pkg]
        root = str(tmp_path / pkg)
        main, _, pred, _ = _mlp(fluid)
        if pkg == "jax":
            scope, exe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
            for n, v in state.items():
                scope.set_var(n, v)
        else:
            scope, exe = (tfluid.scope_from_numpy(state, CPU),
                          tfluid.Executor(CPU))
        # a crashed publish's staging dir is swept by the next publish
        os.makedirs(os.path.join(root, "m", "v9.123.staging.tmp"))
        for v in ("v2", "v10", "v1"):
            io.save_versioned_inference_model(
                root, "m", v, ["x"], [pred], exe, main_program=main,
                scope=scope, manifest={"kind": "engine", "v": v})
        io.set_current_version(root, "m", "v2")
        assert io.list_model_versions(root, "m") == ["v1", "v2", "v10"]
        assert io.current_model_version(root, "m") == "v2"
        assert io.current_model_version(root, "other") is None
        assert sorted(os.listdir(os.path.join(root, "m"))) == [
            "CURRENT", "v1", "v10", "v2"]
    for v in ("v1", "v2", "v10"):
        assert _files(tmp_path / "port" / "m" / v) == \
            _files(tmp_path / "jax" / "m" / v), v
    assert (tmp_path / "port" / "m" / "CURRENT").read_bytes() == b"v2"
    # the reference reads the port's layout
    assert jio.current_model_version(str(tmp_path / "port"), "m") == "v2"


def _host_op_program(fluid, where, kind, path):
    """fc over x with one host IO op of ``kind`` on its weight, placed
    ``where``: "before" the fc, "after" it, or "between" it and a
    scale."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8], "float32")
        out = fluid.layers.fc(x, size=3, bias_attr=False)
        blk = main.global_block()
        w = blk.var("fc_0.w_0")
        slots = ({"inputs": {"X": [w]}} if kind.startswith("save")
                 else {"outputs": {"Out": [w]}})
        blk.append_op(kind, attrs={"file_path": path}, infer_shape=False,
                      **slots)
        if where == "before":
            blk.desc.ops.insert(0, blk.desc.ops.pop())
            blk.ops.insert(0, blk.ops.pop())
        elif where == "between":
            out = fluid.layers.scale(out, 2.0)
    return main, startup, out


@pytest.mark.parametrize("kind", ["save", "save_combine"])
def test_host_save_runs_after_the_step_as_the_reference(kind, tmp_path):
    feed = {"x": _feed()["x"]}
    files = {}
    for pkg in ("jax", "port"):
        fluid, _ = PKG[pkg]
        path = str(tmp_path / pkg)
        main, startup, out = _host_op_program(fluid, "after", kind, path)
        if pkg == "jax":
            scope, exe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
            with jfluid.scope_guard(scope):
                exe.run(startup)
            state = {n: np.asarray(v) for n, v in scope.vars.items()
                     if v is not None}
            with jfluid.scope_guard(scope):
                exe.run(main, feed=feed, fetch_list=[out])
        else:
            scope, exe = tfluid.scope_from_numpy(state, CPU), \
                tfluid.Executor(CPU)
            for _ in range(2):          # a miss, then a hit
                exe.run(main, feed=feed, fetch_list=[out], scope=scope)
        files[pkg] = open(path, "rb").read()
    assert files["port"] == files["jax"]


def test_host_load_runs_before_the_step_and_alone(tmp_path):
    """A block of host ops alone sets the scope and runs no step; a load
    before the compute ops is read by that step, and by the next step of
    a cached entry (the new value copied into its buffer)."""
    path = str(tmp_path / "w")
    w = np.arange(24, dtype=np.float32).reshape(8, 3) / 10
    tio.save_tensor(w, path)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        v = main.global_block().create_var(name="fc_0.w_0", shape=[8, 3],
                                           dtype="float32",
                                           persistable=True)
        main.global_block().append_op("load", outputs={"Out": [v]},
                                      attrs={"file_path": path},
                                      infer_shape=False)
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    assert exe.run(main, scope=scope) == []
    np.testing.assert_array_equal(np.asarray(scope.find_var("fc_0.w_0")), w)
    assert exe.cache_stats()["executable"]["size"] == 0
    prog, startup, out = _host_op_program(tfluid, "before", "load", path)
    assert [op.type for op in prog.global_block().ops][0] == "load"
    x = _feed()["x"]
    scope = tfluid.Scope()
    for step in range(3):
        got, = exe.run(prog, feed={"x": x}, fetch_list=[out], scope=scope)
        np.testing.assert_allclose(got, x @ w, rtol=1e-6)
        tio.save_tensor(w * (step + 2), path)
        w = w * (step + 2)


def test_host_op_between_compute_ops_raises_in_both(tmp_path):
    for pkg in ("jax", "port"):
        fluid, _ = PKG[pkg]
        main, startup, out = _host_op_program(
            fluid, "between", "save", str(tmp_path / pkg))
        place = jfluid.CPUPlace() if pkg == "jax" else CPU
        exe, scope = fluid.Executor(place), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            with pytest.raises(NotImplementedError, match="interleaved"):
                exe.run(main, feed={"x": _feed()["x"]}, fetch_list=[out])


def test_export_stablehlo_is_refused():
    with pytest.raises(NotImplementedError, match="A10"):
        tio.export_stablehlo("d", None, ["x"], ["y"])
    main, _, pred, _ = _mlp(tfluid)
    with pytest.raises(NotImplementedError, match="export_stablehlo"):
        tio.save_inference_model("d", ["x"], [pred], tfluid.Executor(CPU),
                                 main_program=main,
                                 export_stablehlo_module=True)
