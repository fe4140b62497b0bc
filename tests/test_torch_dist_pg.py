"""The process-group ring (``repro_torch.core.dist_pg``) on the CPU: four
gloo processes, started by one subprocess with a timeout.

The reference's draws (``test_torch_dist.JaxMeshReplay``, its
``_round_keys`` chain) are made here with JAX and handed to the ranks in an
npz, so the ranks import no JAX (this file runs as the subprocess's script
and imports JAX only inside the tests).  Each rank records the gradients it
computed; the simulated axis (``core/dist.py``) then runs the same steps on
the same draws with those gradients (``grad_fn``).  A rank's gradient comes
from its own parameters, which are its own copy: the ranks' copies of the
replicated values differ in the rounding of their ring orders, as the
reference's workers' do, and a rank's matmul need not round as the
simulated axis's batched one does.

Tolerances: rank 0's parameters, h and hbar equal the simulated axis's bit
for bit on the pipelined and sequential rings and on the leaf wire, to
1e-5 on psum (``all_reduce`` adds in its own order); with ``local_steps =
2`` (``make_local_step`` between the communicating steps) the same, and
the accumulator too (the simulated local steps are held to the
reference's in ``test_torch_dist.py``); the bytes a rank sends equal (W - 1) times the
codec's wire bytes a communicating step (nothing in a local step), and the
telemetry's ``wire_bytes`` the simulated axis's; a closed peer makes the
others fail within the subprocess's timeout.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.core import dist as tdist
from repro_torch.core import dist_pg
from repro_torch.core import noise as tnoise
from repro_torch.models.toy import ToyMLP
from repro_torch.optim import optimizers as topt

W, STEPS = 4, 5
WIRE = dict(s=3, bucket_bytes=4096, max_buckets=8, bucket_row=64)
CASES = {"pipelined": dict(reduce_impl="pipelined", telemetry=True),
         "sequential": dict(reduce_impl="sequential"),
         "psum": dict(reduce_impl="psum"),
         "leaf": dict(wire="leaf", p_participation=0.5),
         "local": dict(local_steps=2)}
TIMEOUT = 120


def _dcfg(case):
    return tdist.DistConfig(variant="artemis", **WIRE, **CASES[case])


def _communicates(dcfg, i):
    """Whether step i of a run communicates (the train CLI's schedule)."""
    return (i + 1) % dcfg.local_steps == 0


class NpzMeshNoise:
    """Hands out the draws saved in an npz: ``{case}/{k}/{field}[/{i}]``."""

    def __init__(self, data, case, device):
        self.data, self.case, self.device = data, case, device

    def step(self, k, *, faults=False, leaves=()):
        pre = f"{self.case}/{k}/"

        def get(name):
            keys = sorted((key for key in self.data
                           if key.startswith(pre + name + "/")),
                          key=lambda x: int(x.rsplit("/", 1)[1]))
            if keys:
                return [torch.from_numpy(self.data[x]).to(self.device)
                        for x in keys]
            return torch.from_numpy(self.data[pre + name]).to(self.device)

        return tnoise.MeshDraws(u_up=get("u_up"), u_act=get("u_act"),
                                u_dwn=get("u_dwn"))


def _setup(data):
    model = ToyMLP(4, 64)
    params = {k[len("param/"):]: torch.from_numpy(np.array(v))
              for k, v in data.items()
              if k.startswith("param/")}
    batch = {k: torch.from_numpy(np.array(data[f"batch/{k}"]))
             for k in ("x", "y")}
    return model, params, batch


def _rank(rank, world, npz, out_dir, mode):
    """One rank: every case of CASES for STEPS steps on its rows of the
    batch, recording its gradients; or, in mode "closed", rank W - 1 leaves
    at once and the others try to step."""
    data = dict(np.load(npz))
    model, params, batch = _setup(data)
    rows = {k: v.reshape((world, -1) + tuple(v.shape[1:]))[rank]
            for k, v in batch.items()}
    if mode == "closed":
        if rank == world - 1:
            return
        t0 = time.perf_counter()
        init_state, step_fn = dist_pg.make_train_step(
            model, topt.sgd(0.05), _dcfg("pipelined"), device="cpu",
            noise=NpzMeshNoise(data, "pipelined", "cpu"))
        try:
            step_fn(init_state(params), rows)
            msg = "stepped"
        except RuntimeError as exc:
            msg = f"failed: {type(exc).__name__}"
        torch.save({"msg": msg, "secs": time.perf_counter() - t0},
                   os.path.join(out_dir, f"closed{rank}.pt"))
        os._exit(0)     # the group cannot be torn down cleanly now
    out = {}
    for case in CASES:
        recorded = []
        base = dist_pg.rank_grads(model)

        def grad_fn(p, b):
            res = base(p, b)
            recorded.append({k: v.clone() for k, v in res[0].items()})
            return res

        dcfg = _dcfg(case)
        init_state, step_fn = dist_pg.make_train_step(
            model, topt.sgd(0.05), dcfg, device="cpu",
            noise=NpzMeshNoise(data, case, "cpu"), grad_fn=grad_fn)
        local_fn = (dist_pg.make_local_step(model, dcfg, grad_fn=grad_fn)
                    if dcfg.local_steps > 1 else None)
        state, losses, obs = init_state(params), [], []
        for i in range(STEPS):
            if not _communicates(dcfg, i):
                state, _ = local_fn(state, rows)    # this rank's own loss
                continue
            state, (loss, metrics) = step_fn(state, rows)
            losses.append(float(loss))
            if "obs" in metrics:
                obs.append({k: float(v) for k, v in metrics["obs"].items()})
        out[case] = {"params": state.params, "h": state.artemis.h,
                     "hbar": state.artemis.hbar, "acc": state.artemis.acc,
                     "grads": recorded,
                     "losses": losses, "obs": obs,
                     "bytes_sent": step_fn.ring.bytes_sent,
                     "staged": step_fn.ring.staged}
    out["jax_loaded"] = "jax" in sys.modules
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _run(npz, out_dir, mode):
    """The subprocess: W gloo ranks on this host."""
    codes = dist_pg.launch(_rank, W, (npz, out_dir, mode), backend="gloo",
                           timeout=TIMEOUT - 20)
    return 0 if codes == [0] * W else 1


def _draws_npz(path):
    """The reference's draws of every case and step, and the reference's
    ToyMLP(4, 64) parameters and batch, as numpy."""
    import jax
    from repro.models.toy import ToyMLP as JToyMLP
    from test_torch_dist import JaxMeshReplay
    jp = JToyMLP(4, 64).init(jax.random.PRNGKey(0))
    jb = JToyMLP(4, 64).batch(jax.random.PRNGKey(1), n=4 * W)
    from repro_torch import convert
    params = convert.toy_params(jax.tree.map(np.asarray, jp), device="cpu")
    out = {f"param/{k}": v.numpy() for k, v in params.items()}
    out.update({f"batch/{k}": np.asarray(v) for k, v in jb.items()})
    for case in CASES:
        dcfg = _dcfg(case)
        plist = list(params.values())
        shape = (dcfg.layout(plist).shape if dcfg.bucketed
                 else [tuple(p.shape) for p in plist])
        replay = JaxMeshReplay(dcfg.seed, W, shape)
        for k in range(STEPS):
            d = replay.step(k)
            for name in ("u_up", "u_act", "u_dwn"):
                x = getattr(d, name)
                if isinstance(x, list):
                    for i, t in enumerate(x):
                        out[f"{case}/{k}/{name}/{i}"] = t.numpy()
                else:
                    out[f"{case}/{k}/{name}"] = x.numpy()
    np.savez(path, **out)
    return out


def _launch(tmp_path, mode):
    npz = str(tmp_path / "draws.npz")
    data = _draws_npz(npz)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get(
        "PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, __file__, npz, str(tmp_path),
                           mode], capture_output=True, text=True,
                          timeout=TIMEOUT, env=env)
    return proc, data, time.perf_counter() - t0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pg")
    proc, data, _ = _launch(tmp, "steps")
    assert proc.returncode == 0, proc.stderr[-4000:]
    outs = [torch.load(tmp / f"rank{r}.pt") for r in range(W)]
    assert not any(o.pop("jax_loaded") for o in outs)
    return data, outs


def _simulated(data, case, outs):
    """The simulated axis over the same draws and the ranks' gradients."""
    from test_torch_dist import JaxMeshReplay
    model, params, batch = _setup(data)
    dcfg = _dcfg(case)
    plist = list(params.values())
    shape = (dcfg.layout(plist).shape if dcfg.bucketed
             else [tuple(p.shape) for p in plist])
    k = [0]

    def grad_fn(p, split):
        g = {name: torch.stack([o[case]["grads"][k[0]][name] for o in outs])
             for name in p}
        k[0] += 1
        z = torch.zeros(W)
        return g, (z, {"nll": z, "aux": z})

    init_state, step_fn = tdist.make_train_step(
        model, topt.sgd(0.05), dcfg, W, device="cpu",
        noise=JaxMeshReplay(dcfg.seed, W, shape), grad_fn=grad_fn)
    local_fn = (tdist.make_local_step(model, dcfg, W, grad_fn=grad_fn)
                if dcfg.local_steps > 1 else None)
    state, obs = init_state(params), []
    for i in range(STEPS):
        if not _communicates(dcfg, i):
            state, _ = local_fn(state, batch)
            continue
        state, (_, metrics) = step_fn(state, batch)
        obs.append(metrics.get("obs"))
    return state, obs


def _leaves(x):
    return x if isinstance(x, list) else [x]


@pytest.mark.parametrize("case", list(CASES))
def test_rank0_equals_the_simulated_axis(ranks, case):
    data, outs = ranks
    state, obs = _simulated(data, case, outs)
    r0 = outs[0][case]
    pairs = [(r0["params"][k], p) for k, p in state.params.items()]
    pairs += list(zip(_leaves(r0["hbar"]), _leaves(state.artemis.hbar)))
    pairs += [(a[0], b[0]) for a, b in zip(_leaves(r0["h"]),
                                           _leaves(state.artemis.h))]
    if _dcfg(case).local_steps > 1:
        pairs += [(a[0], b[0]) for a, b in zip(_leaves(r0["acc"]),
                                               _leaves(state.artemis.acc))]
    for a, b in pairs:
        if case == "psum":
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
        else:
            assert torch.equal(a, b)
    # every rank's own memory is the simulated axis's worker's
    if case != "psum":
        for r, o in enumerate(outs):
            for a, b in zip(_leaves(o[case]["h"]), _leaves(state.artemis.h)):
                assert torch.equal(a[0], b[r])
    assert all(np.isfinite(o[case]["losses"]).all() for o in outs)
    assert [o[case]["losses"] for o in outs[1:]] == [r0["losses"]] * (W - 1)
    if r0["obs"]:
        for a, b in zip(r0["obs"], obs):
            assert a["wire_bytes"] == b["wire_bytes"]
            assert a["mesh_active"] == float(b["mesh_active"]) == W


@pytest.mark.parametrize("case", ["pipelined", "sequential", "leaf",
                                  "local"])
def test_bytes_per_hop_are_the_codec_wire_bytes(ranks, case):
    data, outs = ranks
    _, params, _ = _setup(data)
    dcfg = _dcfg(case)
    plist = list(params.values())
    if dcfg.bucketed:
        lay = dcfg.layout(plist)
        per_hop = sum(dcfg.wire_codec(lay.row).wire_bytes(
            (lay.n_buckets * lay.rows, lay.row)).values())
    else:
        per_hop = sum(sum(dcfg.wire_codec(tdist.leaf_row(p.shape))
                          .wire_bytes(tuple(p.shape)).values())
                      for p in plist)
    comm = sum(_communicates(dcfg, i) for i in range(STEPS))
    for o in outs:
        assert o[case]["staged"] is False            # gloo on CPU tensors
        assert o[case]["bytes_sent"] == comm * (W - 1) * per_hop
    if outs[0][case]["obs"]:
        assert outs[0][case]["obs"][0]["wire_bytes"] == W * (W - 1) * per_hop


def test_a_closed_peer_fails_the_others_within_the_timeout(tmp_path):
    proc, _, secs = _launch(tmp_path, "closed")
    assert secs < TIMEOUT
    msgs = [torch.load(tmp_path / f"closed{r}.pt") for r in range(W - 1)]
    assert all(m["msg"].startswith("failed") for m in msgs), msgs
    assert max(m["secs"] for m in msgs) < dist_pg.TIMEOUT.total_seconds()


def test_staging_is_decided_by_backend_and_device():
    assert dist_pg.stages_through_host("gloo", "cuda")
    assert not dist_pg.stages_through_host("gloo", "cpu")
    assert not dist_pg.stages_through_host("nccl", "cuda")


def test_rank_draws_slice_every_per_worker_draw():
    src = tnoise.MeshNoise(1, W, [(3, 2), (2,)], "cpu")
    leaves = ((((3, 2), 8), ((3, 1), 32)), (((2,), 8), ((1,), 32)))
    full = src.step(0, faults=True, leaves=leaves)
    one = dist_pg.rank_draws(full, 2)
    assert torch.equal(one.u_up[0], full.u_up[0][2:3])
    assert one.u_dwn is full.u_dwn and torch.equal(one.u_act,
                                                   full.u_act[2:3])
    assert torch.equal(one.flips[1][0][1], full.flips[1][0][1][2:3])
    assert torch.equal(one.u_blow, full.u_blow[2:3])


if __name__ == "__main__":
    sys.exit(_run(sys.argv[1], sys.argv[2], sys.argv[3]))
