"""The port's checkpointer and resumable sweeps.

Checkpointer: atomic saves that leave no temporary file, ``latest_step``
and ``read_manifest``, restores that check keys, shapes and dtypes up
front (the messages tests/test_faults.py expects of the reference), and
the reference's npz layout (a checkpoint of one package restores in the
other).  Sweeps: the checkpointed run equals the plain run bit for bit,
a run resumed from a rewound snapshot equals the uninterrupted one bit for
bit (faulted configs, rollbacks and several variants included), a
snapshot of another sweep is refused, and the argument checks raise as
the reference's do.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.core import artemis as tart
from repro_torch.core import faults as tflt
from repro_torch.core import federated as tfed
from repro_torch.core import sweep as tsw

N, D = 8, 16
FIELDS = ("losses", "bits", "dists", "w_final", "w_avg", "w_tail_avg",
          "rollbacks", "gamma_scale")


def _tree():
    return {"w": torch.arange(6, dtype=torch.float32),
            "step": torch.zeros((), dtype=torch.int32),
            "nested": {"a": [torch.ones(2, 3), np.arange(4, dtype=np.int64)]}}


def test_save_leaves_no_temp_files(tmp_path):
    d = ck.save(str(tmp_path), 3, _tree())
    names = [n for _, _, files in os.walk(tmp_path) for n in files]
    assert not [n for n in names if ".tmp." in n], names
    assert os.path.exists(os.path.join(d, "arrays.npz"))
    assert ck.latest_step(str(tmp_path)) == 3
    assert ck.latest_step(str(tmp_path / "none")) is None


def test_restore_round_trips_structure_and_device(tmp_path):
    tree = _tree()
    ck.save(str(tmp_path), 1, tree)
    out = ck.restore(str(tmp_path), tree)
    assert torch.equal(out["w"], tree["w"])
    assert out["step"].dtype == torch.int32 and out["step"].dim() == 0
    assert isinstance(out["nested"]["a"], list)
    assert torch.equal(out["nested"]["a"][0], torch.ones(2, 3))
    assert isinstance(out["nested"]["a"][1], np.ndarray)
    assert out["w"].device == tree["w"].device


def test_restore_validates_keys_shapes_dtypes(tmp_path):
    ck.save(str(tmp_path), 1, {"w": torch.zeros(6), "step": torch.zeros(
        (), dtype=torch.int32)})
    with pytest.raises(ValueError, match="missing keys"):
        ck.restore(str(tmp_path), {"w": torch.zeros(6), "step": torch.zeros(
            (), dtype=torch.int32), "extra": torch.ones(2)})
    with pytest.raises(ValueError, match="unexpected keys"):
        ck.restore(str(tmp_path), {"w": torch.zeros(6)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(str(tmp_path), {"w": torch.zeros(7), "step": torch.zeros(
            (), dtype=torch.int32)})
    with pytest.raises(ValueError, match="dtype"):
        ck.restore(str(tmp_path), {"w": torch.zeros(6, dtype=torch.int32),
                                   "step": torch.zeros((),
                                                       dtype=torch.int32)})


def _train_state(step=5):
    from repro_torch.core import dist as tdist
    params = {"layers/w": torch.randn(3, 4), "head": torch.randn(4)}
    art = tdist.init_dist_state(tdist.DistConfig(), list(params.values()), 2,
                                device="cpu")
    art = dataclasses.replace(art, h=torch.randn(art.h.shape), step=step)
    opt = {"m": [torch.randn(3, 4), torch.randn(4)],
           "v": [torch.rand(3, 4), torch.rand(4)]}
    return tdist.TrainState(params, opt, art, step)


def test_dataclass_state_round_trips(tmp_path):
    """A ``TrainState`` with its ``ArtemisDistState``: fields in order,
    Python ints as 0-d entries that come back as ints, every tensor bit
    for bit; a state of another layout is refused."""
    state = _train_state()
    ck.save(str(tmp_path), 5, state)
    keys = ck.read_manifest(str(tmp_path))["keys"]
    assert {"step", "artemis/step", "artemis/h", "params/layers_w",
            "opt_state/m/0"} <= set(keys)
    like = dataclasses.replace(_train_state(step=0), params={
        k: torch.zeros_like(v) for k, v in state.params.items()})
    out = ck.restore(str(tmp_path), like)
    assert type(out) is type(state) and type(out.artemis) is type(
        state.artemis)
    assert out.step == 5 and type(out.step) is int
    assert out.artemis.step == 5 and type(out.artemis.step) is int
    assert list(out.params) == list(state.params)
    for a, b in zip(ck._flatten(out).values(), ck._flatten(state).values()):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    other = dataclasses.replace(like, params={"head": torch.zeros(5)})
    with pytest.raises(ValueError, match="head"):
        ck.restore(str(tmp_path), other)


def test_read_manifest_round_trips_extra(tmp_path):
    ck.save(str(tmp_path), 2, _tree(), extra={"fingerprint": "abc"})
    assert ck.read_manifest(str(tmp_path))["extra"]["fingerprint"] == "abc"
    with pytest.raises(FileNotFoundError):
        ck.read_manifest(str(tmp_path / "nope"))
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "nope"), _tree())


def test_format_is_the_references(tmp_path):
    ck.save(str(tmp_path / "a"), 4, {"w": torch.arange(6.0),
                                     "s": torch.tensor(3, dtype=torch.int32)})
    out = jck.restore(str(tmp_path / "a"), {"w": jnp.zeros(6),
                                            "s": jnp.zeros((), jnp.int32)})
    np.testing.assert_array_equal(np.asarray(out["w"]), np.arange(6.0))
    jck.save(str(tmp_path / "b"), 5, {"w": jnp.arange(3.0)})
    back = ck.restore(str(tmp_path / "b"), {"w": torch.zeros(3)})
    assert back["w"].tolist() == [0.0, 1.0, 2.0]


# ---------------------------------------------------------------------------
# resumable sweeps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prob():
    p, _ = tfed.make_lsr_problem(3, n_workers=N, n_per=50, d=D, noise=0.3,
                                 device="cpu")
    return p


CFGS = {
    "clean": [None],
    "faulted": [tflt.FaultConfig(bitflip_rate=0.05, scrub=True,
                                 sentinel=1e4),
                tflt.FaultConfig(blowup_rate=0.1, blowup_value=1e15,
                                 scrub=True, sentinel=1e3),
                tflt.FaultConfig(p_stay=0.9, straggler_rate=0.2)]}


def _cfgs(name):
    base = tart.variant_config("artemis", D, N, p=0.7)
    return [dataclasses.replace(base, faults=fc) for fc in CFGS[name]]


def _run(prob, cfgs, **kw):
    return tsw.run_sweep(prob, cfgs, [0.02, 0.05], [0, 1], 40, batch=4,
                         eval_every=2, device="cpu", **kw)


def _equal(a, b):
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_checkpointed_and_resumed_sweeps_are_bitwise_plain(prob, tmp_path,
                                                           name, backend):
    cfgs = _cfgs(name)
    plain = _run(prob, cfgs, backend=backend)
    ckdir = str(tmp_path / "ck")
    full = _run(prob, cfgs, backend=backend, checkpoint_dir=ckdir,
                checkpoint_every=10)
    _equal(plain, full)
    assert ck.latest_step(ckdir) == 20
    # a crash after the first segment: LATEST rewound to 5 evals
    with open(os.path.join(ckdir, "LATEST"), "w") as f:
        f.write("5")
    resumed = _run(prob, cfgs, backend=backend, checkpoint_dir=ckdir,
                   checkpoint_every=10, resume=True)
    _equal(full, resumed)
    if name == "faulted":
        assert full.rollbacks[1].min() >= 1


def test_resume_without_snapshot_starts_fresh(prob, tmp_path):
    cfgs = _cfgs("clean")
    res = _run(prob, cfgs, checkpoint_dir=str(tmp_path / "new"),
               resume=True)
    _equal(_run(prob, cfgs), res)


def test_resume_refuses_foreign_checkpoint(prob, tmp_path):
    ckdir = str(tmp_path / "ck")
    cfg = _cfgs("clean")
    tsw.run_sweep(prob, cfg, [0.02], [0], 40, batch=4, eval_every=2,
                  device="cpu", checkpoint_dir=ckdir, checkpoint_every=20)
    with pytest.raises(ValueError, match="different sweep"):
        tsw.run_sweep(prob, cfg, [0.05], [0], 40, batch=4, eval_every=2,
                      device="cpu", checkpoint_dir=ckdir,
                      checkpoint_every=20, resume=True)


def test_checkpoint_arg_validation(prob, tmp_path):
    cfg = _cfgs("clean")
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        _run(prob, cfg, resume=True)
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        _run(prob, cfg, checkpoint_every=10)
    with pytest.raises(ValueError, match="group_by_variant"):
        _run(prob, cfg, checkpoint_dir=str(tmp_path), group_by_variant=True)
    with pytest.raises(ValueError, match="multiple"):
        _run(prob, cfg, checkpoint_every=3, checkpoint_dir=str(tmp_path))
