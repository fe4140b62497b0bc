"""The sharded train step on the CPU: the port's ``launch.train --mesh 2x2
--device cpu`` (4 gloo ranks: 2 workers on the data axis, the model
sharded over 2 ranks each) against the reference's ``launch.train --mesh
2x2`` (4 forced host devices), and a resume onto the mesh.

Both CLIs start from the reference's initial parameters, and the port's
ranks replay the reference's draws (``test_torch_dist.JaxMeshReplay``,
handed over in an npz): reduced starcoder2 and reduced olmoe, and on a
``1x4`` mesh (one worker, the model over 4 ranks) reduced starcoder2 with
6 query heads over 2 KV heads at head dim 64 (``RUNS``), artemis on
the bucketed wire, adam, batch 8 x 64, 3 steps, f32 compute (as the
other whole-step tests of the LM stack hold it, so that what is compared
is the sharding and not bf16's rounding of each partial product).

Tolerances: the logged losses (rounded to 4 decimals) to rtol 1e-4, the
reference's whole-run tolerance (DESIGN.md §5): the model axis adds its
partial sums in another order than XLA's partitioner; the parameters each
worker writes (whole) against the reference's to rtol 1e-4, atol 1e-6 on
all but 1e-3 of them (``test_torch_lm_train``'s whole-step bar).  That
test's second bar, atol 1e-4 on every parameter, does not hold here: a
gradient that rounds otherwise can move a wire level by one, and adam
turns that into a step of its own size (measured on starcoder2: 1 of
1,180,928 parameters off by 1.9e-3).  The two workers' checkpoints equal
each other (every rank of the ring adds the same payloads); resuming on
the mesh from a checkpoint: bit for bit with the run that did not stop.

The reference needs 4 CPU devices, fixed when JAX starts, and the port's
ranks are spawned processes that must unpickle the replayed draws: this
file re-invokes itself as a script for both (``ref``, ``port`` and
``resume``), all at once.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ARCHS = ("starcoder2-7b", "olmoe-1b-7b")
MESH, W, STEPS, BATCH, SEQ = "2x2", 2, 3, 8, 64
SEED = 17               # DistConfig's default seed: the reference's draws
TIMEOUT = 300
# every run against the reference: name -> (arch, mesh, config overrides).
# The third is reduced starcoder2 with query heads that do not divide its
# model axis of 4: 6 heads over 2 KV heads at head dim 64, which the
# reference's partitioner splits 2 ways and its head dim 2 ways.
RUNS = {arch: (arch, MESH, {}) for arch in ARCHS}
RUNS["starcoder2-7b-6h"] = ("starcoder2-7b", "1x4",
                            dict(n_heads=6, n_kv=2, head_dim=64))


def _argv(arch, ckpt, steps=STEPS, extra=(), mesh=MESH):
    return ["--arch", arch, "--reduced", "--dist", "artemis", "--mesh", mesh,
            "--steps", str(steps), "--batch", str(BATCH), "--seq", str(SEQ),
            "--log-every", "1", "--ckpt-dir", ckpt, *extra]


def _f32(cfg, **overrides):
    return dataclasses.replace(cfg, compute_dtype="float32", **overrides)


def _workers(run):
    return int(RUNS[run][1].split("x")[0])


class NpzReplay:
    """The reference's draws of each step, saved in an npz by this file
    (``u_up`` [W, B, R, C], ``u_act`` [W], ``u_dwn`` [B, R, C]); picklable,
    so the ranks take it."""

    def __init__(self, arrays):
        self.arrays = arrays

    def step(self, k, *, faults=False, leaves=()):
        from repro_torch.core.noise import MeshDraws
        return MeshDraws(**{name: torch.from_numpy(self.arrays[f"{k}/{name}"])
                            for name in ("u_up", "u_act", "u_dwn")})


# ---------------------------------------------------------------------------
# the two sides, each in a subprocess
# ---------------------------------------------------------------------------

def _inputs(out_dir):
    """The reference's initial parameters and its draws for each run (one
    device is enough): ``<run>.npz``."""
    import jax
    from repro import configs as jconfigs
    from repro.models.model import build_model as jbuild
    from repro_torch.core import dist as tdist
    from repro_torch.models.model import flatten_params
    from test_torch_dist import JaxMeshReplay
    for run, (arch, _, over) in RUNS.items():
        params = jax.tree.map(np.asarray, jbuild(_f32(jconfigs.get_config(
            arch, reduced=True), **over)).init(jax.random.PRNGKey(0)))
        flat = flatten_params(params)
        shape = tdist.DistConfig().layout(
            [tuple(a.shape) for a in flat.values()]).shape
        replay = JaxMeshReplay(SEED, _workers(run), shape)
        out = {f"param/{k}": a for k, a in flat.items()}
        for k in range(STEPS):
            draws = replay.step(k)
            for name in ("u_up", "u_act", "u_dwn"):
                out[f"draw/{k}/{name}"] = getattr(draws, name).numpy()
        np.savez(os.path.join(out_dir, f"{run}.npz"), **out)


def _reference(out_dir):
    """The reference's CLI on 4 host devices, each run into ``ref-<run>/``
    on its mesh."""
    import jax
    from repro import configs as jconfigs
    from repro.launch import train as jtrain
    assert jax.device_count() == 4, jax.devices()
    get = jconfigs.get_config
    for run, (arch, mesh, over) in RUNS.items():
        jconfigs.get_config = lambda arch, reduced=False, over=over: _f32(
            get(arch, reduced), **over)
        ckpt = os.path.join(out_dir, f"ref-{run}")
        logs = jtrain.main(_argv(arch, ckpt, mesh=mesh))
        np.save(os.path.join(out_dir, f"ref-{run}.npy"),
                [r["loss"] for r in logs])
    jconfigs.get_config = get


def _port(out_dir, run, tag, steps, extra):
    """The port's CLI on the run's mesh of 4 gloo ranks from the
    reference's parameters, replaying its draws."""
    from repro_torch import configs as tconfigs
    from repro_torch.launch import train
    arch, mesh, over = RUNS[run]
    data = dict(np.load(os.path.join(out_dir, f"{run}.npz")))
    params = {k[len("param/"):]: v for k, v in data.items()
              if k.startswith("param/")}
    noise = NpzReplay({k[len("draw/"):]: v for k, v in data.items()
                       if k.startswith("draw/")})
    logs = train.main(_argv(arch, os.path.join(out_dir, tag), steps,
                            extra + ["--device", "cpu"], mesh=mesh),
                      config=_f32(tconfigs.get_config(arch, reduced=True),
                                  **over),
                      params=params, noise=noise)
    np.save(os.path.join(out_dir, f"{tag}.npy"), [r["loss"] for r in logs])


def _env(devices=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(here, "..", "src"), here, env.get("PYTHONPATH", "")])
    return env


def _script(*args, devices=None):
    cmd = [sys.executable, os.path.abspath(__file__), *map(str, args)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=_env(devices))


def _ckpt_params(ckpt_dir, prefix):
    step = open(os.path.join(ckpt_dir, "LATEST")).read().strip()
    data = np.load(os.path.join(ckpt_dir, f"step_{int(step):08d}",
                                "arrays.npz"))
    # the port's npz names escape the "/" within a key
    return {k[len(prefix):].replace("/", "_"): data[k]
            for k in data if k.startswith(prefix)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the module, side by side: the reference's, the port's
    3-step runs of ``RUNS``, and starcoder2's 2 steps then 1 resumed."""
    out = tmp_path_factory.mktemp("mesh_train")
    _inputs(out)
    procs = [_script("ref", out, devices=4)]
    procs += [_script("port", out, run, f"port-{run}", STEPS)
              for run in RUNS]
    procs.append(_script("resume", out))
    try:
        errors = [p.communicate(timeout=TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, err in zip(procs, errors):
        assert p.returncode == 0, err[-3000:]
    return out


@pytest.mark.parametrize("arch", RUNS)
def test_mesh_train_matches_the_reference(runs, arch):
    losses = np.load(runs / f"port-{arch}.npy")
    ref_losses = np.load(runs / f"ref-{arch}.npy")
    assert len(losses) == STEPS and np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    from test_torch_dist import assert_mostly_close
    ref = _ckpt_params(runs / f"ref-{arch}", ".params/")
    workers = [_ckpt_params(runs / f"port-{arch}" / f"rank{w}", "params/")
               for w in range(_workers(arch))]
    assert sorted(workers[0]) == sorted(ref)
    for k in ref:
        for other in workers[1:]:
            np.testing.assert_array_equal(other[k], workers[0][k],
                                          err_msg=k)
    flat = np.concatenate([workers[0][k].ravel() for k in sorted(ref)])
    flat_ref = np.concatenate([ref[k].ravel() for k in sorted(ref)])
    assert_mostly_close(flat, flat_ref, rtol=1e-4, atol=1e-6, frac=1e-3)


def test_mesh_resume_is_bit_for_bit(runs):
    arch = ARCHS[0]
    np.testing.assert_array_equal(np.load(runs / "resumed.npy"),
                                  np.load(runs / f"port-{arch}.npy")[-1:])
    for w in range(W):
        whole = np.load(runs / f"port-{arch}" / f"rank{w}" / "step_00000003"
                        / "arrays.npz")
        resumed = np.load(runs / "resumed" / f"rank{w}" / "step_00000003"
                          / "arrays.npz")
        assert sorted(whole) == sorted(resumed)
        for k in whole:
            np.testing.assert_array_equal(resumed[k], whole[k], err_msg=k)


def test_mesh_backend_comes_from_the_device(monkeypatch, capsys):
    """The mesh takes nccl on CUDA (one card a rank: more ranks than cards
    are refused before any rank starts) and gloo on the CPU; no option
    picks another backend."""
    import torch
    from repro_torch.core import dist_pg
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    started = []

    class Started(Exception):
        pass

    def launch(*args, backend, **kw):
        started.append(backend)
        raise Started

    monkeypatch.setattr(dist_pg, "launch", launch)
    with pytest.raises(SystemExit):
        train.main(["--arch", ARCHS[0], "--reduced", "--mesh", "2x2"])
    assert "nccl takes one card a rank" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        train.main(["--arch", ARCHS[0], "--reduced", "--mesh", "1x1",
                    "--backend", "gloo"])
    assert "unrecognized arguments: --backend" in capsys.readouterr().err
    for device, backend in (("cuda", "nccl"), ("cpu", "gloo")):
        with pytest.raises(Started):    # the stub starts no rank
            train.main(["--arch", ARCHS[0], "--reduced", "--mesh", "1x1",
                        "--device", device])
        assert started.pop() == backend


# ---------------------------------------------------------------------------
# attention on DTensors: each rank on its block of the heads
# ---------------------------------------------------------------------------

# (query heads, KV heads, head dim, d_model) over a model axis of 4, by
# test id.  At d_model 16 the policy would leave every weight whole, so
# those cases split q, k, v over their output dim and wo over its input dim
# as it splits large ones: KV heads gathered under split query heads that
# share one KV head (8, 2; 4, 1) or make whole KV groups (12, 6); KV heads
# split with their query heads (8, 8; 16, 4); query heads that do not
# divide the axis (6, 2).  At d_model 256 the weights are placed by the
# policy (``launch.mesh.param_spec``): query heads that do not divide the
# axis, K/V whole (6, 2 at head dim 32; 10, 1) or split (6, 2 at 64; 6, 6).
ATTN_CASES = {"8-2": (8, 2, 4, 16), "4-1": (4, 1, 4, 16),
              "12-6": (12, 6, 4, 16), "8-8": (8, 8, 4, 16),
              "16-4": (16, 4, 4, 16), "6-2": (6, 2, 4, 16),
              "6-2-32": (6, 2, 32, 256), "6-2-64": (6, 2, 64, 256),
              "10-1": (10, 1, 32, 256), "6-6": (6, 6, 32, 256)}
# each rank's block (query heads, KV heads, head-dim lanes), as the
# reference's attn_apply compiled on 4 host devices gives it (read from the
# HLO's per-device softmax and score all-reduce; tests/test_torch_heads.py
# holds this table to that compile)
ATTN_EXTENTS = {"8-2": (2, 1, 4), "4-1": (1, 1, 4), "12-6": (6, 3, 4),
                "8-8": (2, 2, 4), "16-4": (4, 1, 4), "6-2": (3, 1, 2),
                "6-2-32": (3, 1, 32), "6-2-64": (3, 1, 32),
                "10-1": (5, 1, 32), "6-6": (3, 3, 32)}
ATTN_MODEL = 4
ATTN_BATCH, ATTN_SEQ = 2, 8
# From this d_model on a case runs in float64, the plain layer too.  At
# d_model 256 the weights' gradients reach 39 and cancel: the plain f32
# layer's own differ from float64's by up to 1.4e-5, above the bar's atol,
# and the model axis's partial sums (the output projection's rows, a KV
# head shared by two blocks, the score partials of split lanes) round
# otherwise.  In float64 any error of the partition shows far above the
# bar and rounding far below it.
ATTN_F64 = 128


def attn_specs(n_heads, n_kv, head_dim, d_model, param_spec=None):
    """Each attention weight's model-axis split in a case, ``None`` or
    ``"model"`` for each of its two dims: by ``param_spec(path, shape)``
    (a policy's spec on a mesh whose data axis is 1) from d_model 128 on,
    else forced (q, k, v over their output dim, wo over its input dim)."""
    shapes = {"wq": (d_model, n_heads * head_dim),
              "wk": (d_model, n_kv * head_dim),
              "wv": (d_model, n_kv * head_dim),
              "wo": (n_heads * head_dim, d_model)}
    if d_model < 128:
        return {k: (None, "model") if k != "wo" else ("model", None)
                for k in shapes}
    return {k: tuple(e if e == "model" else None
                     for e in (tuple(param_spec("attn/" + k, s))
                               + (None, None))[:2])
            for k, s in shapes.items()}


def _attn_case(case):
    """A case's weights, input, output gradient and keywords: f32 draws,
    held (and the softmax run) in float64 at d_model 256 (``ATTN_F64``)."""
    n_heads, n_kv, hd, d = ATTN_CASES[case]
    gen = torch.Generator().manual_seed(n_heads * 100 + n_kv)
    from repro_torch.models import layers as L
    dtype = torch.float64 if d >= ATTN_F64 else torch.float32
    p = L.init_attn(gen, d, n_heads, n_kv, hd, dtype=dtype)
    x = torch.randn(ATTN_BATCH, ATTN_SEQ, d, generator=gen).to(dtype)
    cot = torch.randn(ATTN_BATCH, ATTN_SEQ, d, generator=gen).to(dtype)
    kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=hd, window=0,
              rope_theta=10000.0, softmax_dtype=max(dtype, torch.float32,
                                                    key=_width))
    return p, x, cot, kw


def _width(dtype):
    return torch.finfo(dtype).bits


def _attn_rank(rank, world, out_dir):
    """Every ATTN_CASES case on a (1, ATTN_MODEL) mesh, the weights split
    as ``attn_specs`` says: the output and every gradient, gathered, and
    the block each rank ran (``layers.recording_blocks``)."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.core import dist as tdist
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L
    mesh = tdist.make_worker_mesh((1, ATTN_MODEL), ("data", "model"),
                                  device_type="cpu")
    out = {}
    for case in ATTN_CASES:
        p, x, cot, kw = _attn_case(case)
        specs = attn_specs(*ATTN_CASES[case], param_spec=lambda k, s: (
            M.param_spec(mesh, k, s)))
        sp = {k: distribute_tensor(w.detach(), mesh, [Replicate(), next(
            (Shard(i) for i, e in enumerate(specs[k]) if e == "model"),
            Replicate())]).requires_grad_() for k, w in p.items()}
        sx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        sx.requires_grad_()
        pos = torch.arange(ATTN_SEQ)
        with implicit_replication(), L.recording_blocks() as ran:
            y, _ = L.attn_apply(sp, sx, pos, **kw)
            y.backward(distribute_tensor(cot, mesh, y.placements))
        res = {"y": y.full_tensor().detach(), "x": sx.grad.full_tensor(),
               "blocks": list(ran)}
        res.update({k: w.grad.full_tensor() for k, w in sp.items()})
        out[case] = res
    torch.save(out, os.path.join(out_dir, f"attn{rank}.pt"))


def _attn_script(out_dir):
    from repro_torch.core import dist_pg
    codes = dist_pg.launch(_attn_rank, ATTN_MODEL, (out_dir,), timeout=240)
    assert codes == [0] * ATTN_MODEL, codes


@pytest.fixture(scope="module")
def attn_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("attn")
    proc = _script("attn", out)
    err = proc.communicate(timeout=TIMEOUT)[1]
    assert proc.returncode == 0, err[-3000:]
    return [torch.load(out / f"attn{r}.pt") for r in range(ATTN_MODEL)]


@pytest.mark.parametrize("case", [pytest.param(c, id=c) for c in ATTN_CASES])
def test_sharded_attention_splits_query_heads(attn_runs, case):
    """The sharded attention against the plain one on the same inputs
    (rtol 1e-5, atol 1e-6: the same products, each rank on its block, the
    split head dim's score partials summed over its lane group); every
    rank runs the block the reference's compile gives it
    (``ATTN_EXTENTS``)."""
    from repro_torch.models import layers as L
    p, x, cot, kw = _attn_case(case)
    p = {k: w.requires_grad_() for k, w in p.items()}
    x.requires_grad_()
    y, _ = L.attn_apply(p, x, torch.arange(ATTN_SEQ), **kw)
    y.backward(cot)
    want = {"y": y.detach(), "x": x.grad,
            **{k: w.grad for k, w in p.items()}}
    for r, got in enumerate(attn_runs):
        res = got[case]
        assert res["blocks"] == [ATTN_EXTENTS[case]], (r, res["blocks"])
        for k, w in want.items():
            torch.testing.assert_close(res[k], w, rtol=1e-5, atol=1e-6,
                                       msg=f"rank {r} {k}")


if __name__ == "__main__":
    what, where = sys.argv[1], sys.argv[2]
    if what == "attn":
        _attn_script(where)
    elif what == "ref":
        _reference(where)
    elif what == "resume":
        _port(where, ARCHS[0], "resumed", STEPS - 1, [])
        _port(where, ARCHS[0], "resumed", 1, ["--resume"])
    else:
        _port(where, sys.argv[3], sys.argv[4], int(sys.argv[5]),
              sys.argv[6:])
