"""The one-card dry run (``launch/dryrun.py``) and ``configs.input_specs``
on the CPU.

``input_specs`` gives meta tensors of the reference's
``ShapeDtypeStruct`` shapes and dtypes, the decode cache included.  The dry
run of two reduced configs (a train step over the Artemis wire at W = 2, a
decode step) counts exactly the FLOPs that ``FlopCounterMode`` counts on
real CPU tensors of the same shapes, and its parameter bytes are
``count_params`` (the port's, equal to the reference's) times the
parameter dtype's size.  The live-bytes tracker is held to a hand-counted
peak.  Rematerialisation (``remat``) lowers a deep train step's peak and
adds a forward's FLOPs; the overrides reach every combo of ``--all``.
"""
import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.launch import roofline as jroofline
from repro.models.model import build_model as jbuild
from repro_torch import configs
from repro_torch.core import dist
from repro_torch.launch import dryrun, report
from repro_torch.launch import roofline as troofline
from repro_torch.models.model import build_model, flatten_params
from repro_torch.optim import sgd

ARCHS = ["starcoder2-7b", "whisper-tiny", "recurrentgemma-2b",
         "llava-next-mistral-7b", "olmoe-1b-7b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: under the suite's worker processes torch's
    per-core pools spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shapes_dtypes(tree):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in tree]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_input_specs_match_the_reference(arch, shape):
    sh = configs.SHAPES[shape]
    small = configs.InputShape(sh.name, sh.kind, 64, 2)
    jsmall = jconfigs.InputShape(sh.name, sh.kind, 64, 2)
    ref = jconfigs.input_specs(jconfigs.get_config(arch, reduced=True),
                               jsmall)
    got = configs.input_specs(configs.get_config(arch, reduced=True), small)
    flat = flatten_params(got)
    assert all(t.device.type == "meta" for t in flat.values())
    assert _shapes_dtypes(flat.values()) == _shapes_dtypes(
        jax.tree.leaves(ref))


def _real_flops(arch, shape, workers):
    """FlopCounterMode over the same step on real CPU tensors."""
    cfg = configs.get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    specs = configs.input_specs(cfg, shape, model)
    real = {k: (torch.zeros(v.shape, dtype=v.dtype)
                if isinstance(v, torch.Tensor) else v)
            for k, v in specs.items() if k != "cache"}
    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            init_state, step_fn = dist.make_train_step(
                model, sgd(1e-2), dist.DistConfig(variant="artemis"),
                workers, device="cpu")
            step_fn(init_state(params), real)
        else:
            cache = model.init_cache(shape.batch, shape.seq, device="cpu")
            model.decode_step(params, cache, real["token"], shape.seq - 1,
                              enc_out=real.get("enc_out"))
    return fc.get_total_flops(), cfg, params


@pytest.mark.parametrize("arch,shape,dist_variant", [
    ("starcoder2-7b", "train_4k", "artemis"),
    ("whisper-tiny", "decode_32k", "none")])
def test_dry_run_counts_the_real_step(arch, shape, dist_variant):
    batch, seq, workers = 4, 64, 2
    rec = dryrun.lower_one(arch, shape, dist_variant, workers=workers,
                           batch=batch, seq=seq, reduced=True)
    assert rec["status"] == "ok" and rec["workers"] == (
        workers if dist_variant != "none" else 1)
    sh = dryrun._shape(shape, batch, seq)
    flops, cfg, params = _real_flops(arch, sh, workers)
    assert rec["flops"] == flops > 0
    # the parameters: the reference's count times the dtype's size
    jcfg = jconfigs.get_config(arch, reduced=True)
    jparams = jax.eval_shape(lambda: jbuild(jcfg).init(
        jax.random.PRNGKey(0)))
    itemsize = np.dtype(jcfg.param_dtype).itemsize
    assert troofline.count_params(params) == jroofline.count_params(jparams)
    assert rec["param_bytes"] == troofline.count_params(params) * itemsize
    assert rec["param_bytes"] == sum(p.numel() * p.element_size()
                                     for p in params.values())
    assert rec["peak_bytes"] >= rec["param_bytes"] + rec["artemis_bytes"]
    if dist_variant == "artemis":
        assert rec["artemis_bytes"] > 0 and rec["wire_s"] > 0
    for term in ("compute_s", "memory_s"):
        assert rec[term] > 0
    assert rec["dominant"] in ("compute", "memory", "wire")


@pytest.mark.parametrize("arch", ["starcoder2-7b", "recurrentgemma-2b",
                                  "whisper-tiny"])
def test_remat_lowers_a_deep_train_peak(arch):
    """At 12 layers (the uniform stack, the pattern groups, the encoder):
    remat frees every layer's activations between forward and backward,
    and recomputes the forward's FLOPs; the dots policy recomputes no
    product."""
    def run(**over):
        return dryrun.lower_one(
            arch, "train_4k", "none", batch=4, seq=128, reduced=True,
            cfg_overrides={"n_layers": 12, "enc_layers": 12, **over})
    off = run(remat=False)
    full = run(remat=True, remat_policy=None)
    dots = run(remat=True, remat_policy="dots_saveable")
    assert full["peak_bytes"] < 0.6 * off["peak_bytes"], (full, off)
    assert dots["peak_bytes"] < off["peak_bytes"]
    assert off["flops"] < full["flops"] < 1.5 * off["flops"]
    assert dots["flops"] == off["flops"]


def test_overrides_parse_and_reach_every_combo(monkeypatch):
    assert dryrun._parse_overrides(["remat=False", "remat_policy=None",
                                    "n_layers=2", "q_chunk=64"]) == {
        "remat": False, "remat_policy": None, "n_layers": 2, "q_chunk": 64}
    assert dryrun._parse_overrides(["remat=True"]) == {"remat": True}
    cmds = []

    class Done:
        def __init__(self, cmd, **_):
            cmds.append(cmd)

        def poll(self):
            return 0

        def communicate(self):
            return ("", None)

    monkeypatch.setattr(dryrun.subprocess, "Popen", Done)
    monkeypatch.setattr(dryrun, "_combos",
                        lambda: iter([("starcoder2-7b", "train_4k", None,
                                       "none")]))
    dryrun.run_all(1, 8, cfg_override=["remat=False"])
    assert cmds[0][-2:] == ["--cfg-override", "remat=False"]


def test_live_bytes_tracks_a_hand_counted_peak():
    live = dryrun.LiveBytes()
    with live:
        a = torch.empty(1000)                   # 4000 B live
        b = a * 2                               # 8000 B
        del a                                   # 4000 B
        c = b[:10].clone()                      # 4040 B
        d = torch.cat([b, b])                   # 12040 B, the peak
        del b, c, d                             # 0 B
        e = torch.empty(100, dtype=torch.float64)   # 800 B
    assert live.peak == 12040
    assert live.live == 800 and e.numel() == 100
    # each op's inputs and outputs once; the view b[:10] moves nothing
    assert live.accessed == (4000 + (4000 + 4000) + (40 + 40)
                             + (8000 + 8000) + 800)


def test_skips_and_the_mesh_are_refused(capsys):
    """Skips, on one card and on a mesh (before any process group is made),
    and a mesh the reference does not have, which argparse refuses."""
    rec = dryrun.lower_one("whisper-tiny", "long_500k")
    assert rec["status"] == "skip"
    rec = dryrun.lower_mesh("whisper-tiny", "long_500k", "multipod")
    assert rec["status"] == "skip" and rec["chips"] == 512
    assert rec["mesh"] == "multipod"
    with pytest.raises(SystemExit):
        dryrun.main(["--mesh", "galaxy", "--arch", "starcoder2-7b",
                     "--shape", "train_4k"])
    assert "invalid choice" in capsys.readouterr().err


def test_cli_and_report(tmp_path, capsys):
    out = tmp_path / "d.json"
    assert dryrun.main(["--arch", "starcoder2-7b", "--shape", "prefill_32k",
                        "--reduced", "--batch", "2", "--seq", "64", "--out",
                        str(out)]) == 0
    capsys.readouterr()
    report.main(str(out))
    text = capsys.readouterr().out
    assert "| starcoder2-7b | prefill_32k | none | 1 | prefill |" in text
    assert "fits 80 GB H100?" in text and "OK" in text
