"""The sharded train step on the CPU: the port's ``launch.train --mesh 2x2
--device cpu`` (4 gloo ranks: 2 workers on the data axis, the model
sharded over 2 ranks each) against the reference's ``launch.train --mesh
2x2`` (4 forced host devices), and a resume onto the mesh.

Both CLIs start from the reference's initial parameters, and the port's
ranks replay the reference's draws (``test_torch_dist.JaxMeshReplay``,
handed over in an npz): reduced starcoder2 and reduced olmoe, artemis on
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


def _argv(arch, ckpt, steps=STEPS, extra=()):
    return ["--arch", arch, "--reduced", "--dist", "artemis", "--mesh", MESH,
            "--steps", str(steps), "--batch", str(BATCH), "--seq", str(SEQ),
            "--log-every", "1", "--ckpt-dir", ckpt, *extra]


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


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
    """The reference's initial parameters and its draws for each arch (one
    device is enough): ``<arch>.npz``."""
    import jax
    from repro import configs as jconfigs
    from repro.models.model import build_model as jbuild
    from repro_torch.core import dist as tdist
    from repro_torch.models.model import flatten_params
    from test_torch_dist import JaxMeshReplay
    for arch in ARCHS:
        params = jax.tree.map(np.asarray, jbuild(_f32(jconfigs.get_config(
            arch, reduced=True))).init(jax.random.PRNGKey(0)))
        flat = flatten_params(params)
        shape = tdist.DistConfig().layout(
            [tuple(a.shape) for a in flat.values()]).shape
        replay = JaxMeshReplay(SEED, W, shape)
        out = {f"param/{k}": a for k, a in flat.items()}
        for k in range(STEPS):
            draws = replay.step(k)
            for name in ("u_up", "u_act", "u_dwn"):
                out[f"draw/{k}/{name}"] = getattr(draws, name).numpy()
        np.savez(os.path.join(out_dir, f"{arch}.npz"), **out)


def _reference(out_dir):
    """The reference's CLI on a 2 x 2 mesh of 4 host devices, each arch
    into ``ref-<arch>/``."""
    import jax
    from repro import configs as jconfigs
    from repro.launch import train as jtrain
    assert jax.device_count() == 4, jax.devices()
    get = jconfigs.get_config
    jconfigs.get_config = lambda arch, reduced=False: _f32(get(arch, reduced))
    for arch in ARCHS:
        ckpt = os.path.join(out_dir, f"ref-{arch}")
        logs = jtrain.main(_argv(arch, ckpt))
        np.save(os.path.join(out_dir, f"ref-{arch}.npy"),
                [r["loss"] for r in logs])


def _port(out_dir, arch, tag, steps, extra):
    """The port's CLI on a 2 x 2 mesh of 4 gloo ranks from the reference's
    parameters, replaying its draws."""
    from repro_torch import configs as tconfigs
    from repro_torch.launch import train
    data = dict(np.load(os.path.join(out_dir, f"{arch}.npz")))
    params = {k[len("param/"):]: v for k, v in data.items()
              if k.startswith("param/")}
    noise = NpzReplay({k[len("draw/"):]: v for k, v in data.items()
                       if k.startswith("draw/")})
    logs = train.main(_argv(arch, os.path.join(out_dir, tag), steps,
                            extra + ["--device", "cpu"]),
                      config=_f32(tconfigs.get_config(arch, reduced=True)),
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
    3-step runs of both archs, and starcoder2's 2 steps then 1 resumed."""
    out = tmp_path_factory.mktemp("mesh_train")
    _inputs(out)
    procs = [_script("ref", out, devices=4)]
    procs += [_script("port", out, arch, f"port-{arch}", STEPS)
              for arch in ARCHS]
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


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_matches_the_reference(runs, arch):
    losses = np.load(runs / f"port-{arch}.npy")
    ref_losses = np.load(runs / f"ref-{arch}.npy")
    assert len(losses) == STEPS and np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    from test_torch_dist import assert_mostly_close
    ref = _ckpt_params(runs / f"ref-{arch}", ".params/")
    workers = [_ckpt_params(runs / f"port-{arch}" / f"rank{w}", "params/")
               for w in range(W)]
    assert sorted(workers[0]) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(workers[1][k], workers[0][k],
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
# attention on DTensors: each rank on its own query heads
# ---------------------------------------------------------------------------

# (query heads, KV heads) over a model axis of 4: KV heads gathered under
# split query heads that share one KV head (8, 2; 4, 1) or straddle two
# (12, 6); KV heads split with their query heads (8, 8; 16, 4); query
# heads that do not divide, so nothing is split (6, 2)
ATTN_CASES = ((8, 2), (4, 1), (12, 6), (8, 8), (16, 4), (6, 2))
ATTN_MODEL = 4


def _attn_rank(rank, world, out_dir):
    """Every ATTN_CASES case on a (1, ATTN_MODEL) mesh, the weights split
    as the policy splits them (q, k, v over their output dim, wo over its
    input dim): the output and every gradient, gathered, and the query
    heads each local block ran with."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.core import dist as tdist
    from repro_torch.models import layers as L
    mesh = tdist.make_worker_mesh((1, ATTN_MODEL), ("data", "model"),
                                  device_type="cpu")
    ran = []
    block = L._attn_block

    def recording(q, *args):
        if not hasattr(q, "device_mesh"):
            ran.append(q.shape[2])
        return block(q, *args)

    L._attn_block = recording
    out = {}
    for n_heads, n_kv in ATTN_CASES:
        hd, d, b, s = 4, 16, 2, 8
        gen = torch.Generator().manual_seed(n_heads * 100 + n_kv)
        p = L.init_attn(gen, d, n_heads, n_kv, hd)
        x = torch.randn(b, s, d, generator=gen)
        cot = torch.randn(b, s, d, generator=gen)
        pos = torch.arange(s)
        kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=hd, window=0,
                  rope_theta=10000.0)
        split = {"wq": Shard(1), "wk": Shard(1), "wv": Shard(1),
                 "wo": Shard(0)}
        sp = {k: distribute_tensor(w.detach(), mesh,
                                   [Replicate(), split[k]]).requires_grad_()
              for k, w in p.items()}
        sx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        sx.requires_grad_()
        ran.clear()
        with implicit_replication():    # as the mesh step runs the model
            y, _ = L.attn_apply(sp, sx, pos, **kw)
            y.backward(distribute_tensor(cot, mesh, y.placements))
        res = {"y": y.full_tensor().detach(), "x": sx.grad.full_tensor(),
               "heads": list(ran)}
        res.update({k: w.grad.full_tensor() for k, w in sp.items()})
        out[f"{n_heads}x{n_kv}"] = res
    L._attn_block = block
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


@pytest.mark.parametrize("n_heads,n_kv", ATTN_CASES)
def test_sharded_attention_splits_query_heads(attn_runs, n_heads, n_kv):
    """The sharded attention against the plain one on the same inputs
    (rtol 1e-5, atol 1e-6: the same products, each rank on its heads);
    every rank runs only its own query heads wherever they divide the
    model axis, whether or not the KV heads do."""
    from repro_torch.models import layers as L
    case = f"{n_heads}x{n_kv}"
    hd, d, b, s = 4, 16, 2, 8
    gen = torch.Generator().manual_seed(n_heads * 100 + n_kv)
    p = {k: w.requires_grad_() for k, w in
         L.init_attn(gen, d, n_heads, n_kv, hd).items()}
    x = torch.randn(b, s, d, generator=gen).requires_grad_()
    cot = torch.randn(b, s, d, generator=gen)
    y, _ = L.attn_apply(p, x, torch.arange(s), n_heads=n_heads, n_kv=n_kv,
                        head_dim=hd, window=0, rope_theta=10000.0)
    y.backward(cot)
    want = {"y": y.detach(), "x": x.grad,
            **{k: w.grad for k, w in p.items()}}
    local = n_heads // ATTN_MODEL if n_heads % ATTN_MODEL == 0 else n_heads
    for r, got in enumerate(attn_runs):
        res = got[case]
        assert res["heads"] == [local], (r, res["heads"])
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
