"""The attention partition on the model axis (``models/layers.py``:
``head_partition``, ``_sharded_attention``) against the reference's
compiled program.

The reference runs in a subprocess with 256 forced host devices: one
``repro.models.layers.attn_apply`` layer of each arch with attention (its
full heads, KV heads, head dim and d_model; whisper-tiny's cross-attention
too, its K/V made from the frames as the reference's model makes them) on
the production pod mesh, the weights at ``param_spec``'s sharding and x at
``P("data")``, all ``ShapeDtypeStruct`` (nothing is allocated), compiled.
From the HLO it reads each device's block: the per-device shape of the
softmax's ``exponential`` ([B, KV, rep, Sq, Sk]: the query heads are KV x
rep) and, where the head dim is split, the group size of the score
products' all-reduce (the lanes are the head dim over it).  The same
subprocess compiles ``test_torch_mesh_train``'s ``ATTN_CASES`` on a model
axis of 4 (the first 4 devices).

The port runs in one subprocess per rank of ``RANKS``, each that rank of
a fake process group of 256 ranks (the dry run's mechanism: collectives
move nothing, tensors are fake): the same layers on DTensors, recording
the block each ``_sharded_attention`` runs (``layers.recording_blocks``)
and the layer's collectives by mesh axis (``dryrun.RankCounter`` and its
``CommDebugMode``; the tests read rank 0's).  Every block must equal the
reference's.

About 10 s: the reference compiles a layer in under a second.
"""
import json
import os
import re
import subprocess
import sys

import pytest

from test_torch_mesh_train import ATTN_CASES, ATTN_EXTENTS, attn_specs

ARCHS = ("whisper-tiny", "olmoe-1b-7b", "minitron-8b", "nemotron-4-15b",
         "llava-next-mistral-7b", "mixtral-8x22b", "recurrentgemma-2b",
         "mistral-large-123b", "starcoder2-7b")    # falcon-mamba-7b: none
LAYERS = [(a, "self") for a in ARCHS] + [("whisper-tiny", "cross")]
BATCH, SEQ = 16, 256        # a batch row a data rank; one query chunk
RANKS = (0, 37, 255)
TIMEOUT = 300


def _shapes(cfg):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    return {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
            "wo": (h * hd, d)}


# ---------------------------------------------------------------------------
# the reference (256 host devices) and the port (a fake group), as scripts
# ---------------------------------------------------------------------------

def _read_hlo(text: str, head_dim: int) -> list:
    """[query heads, KV heads, lanes] of the one softmax block in ``text``
    (a compiled module's HLO) and the lanes its score products' all-reduce
    leaves (the head dim over its group size; all of it without one)."""
    exps = set(re.findall(r"= f32\[([\d,]+)\]\{[^}]*\} exponential\(", text))
    assert len(exps) == 1, exps
    b, kv, rep, _, _ = map(int, exps.pop().split(","))
    groups = {int(g) for shape, g in re.findall(
        r"= f32\[([\d,]+)\]\{[^}]*\} all-reduce\([^\n]*?"
        r"replica_groups=\[\d+,(\d+)\]", text)
        if len(shape.split(",")) == 5}
    assert len(groups) <= 1, groups
    return [kv * rep, kv, head_dim // (groups.pop() if groups else 1)]


def _reference(out_dir):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.launch import mesh as M
    from repro.models import layers as L
    assert jax.device_count() == 256, jax.devices()

    def compile_layer(mesh, shapes, specs, h, kv, hd, frames=None):
        d, b = shapes["wq"][0], mesh.devices.shape[0]  # a row a data rank
        p = {k: jax.ShapeDtypeStruct(s, jnp.float32, sharding=NamedSharding(
            mesh, P(*specs[k]))) for k, s in shapes.items()}
        x = jax.ShapeDtypeStruct((b, SEQ, d), jnp.float32,
                                 sharding=NamedSharding(mesh, P("data")))
        pos = jax.ShapeDtypeStruct((SEQ,), jnp.int32,
                                   sharding=NamedSharding(mesh, P()))
        kw = dict(n_heads=h, n_kv=kv, head_dim=hd)
        if frames is None:
            def fn(p, x, pos):
                return L.attn_apply(p, x, pos, **kw)[0]
            args = (p, x, pos)
        else:
            enc = jax.ShapeDtypeStruct((b, frames, d), jnp.float32,
                                       sharding=NamedSharding(mesh,
                                                              P("data")))

            def fn(p, x, pos, enc):     # the reference model's _cross_kv
                ck = (enc @ p["wk"]).reshape(b, frames, kv, hd)
                cv = (enc @ p["wv"]).reshape(b, frames, kv, hd)
                return L.attn_apply(p, x, pos, causal=False, cross_kv=(
                    ck, cv, jnp.arange(frames)), **kw)[0]
            args = (p, x, pos, enc)
        text = jax.jit(fn).lower(*args).compile().as_text()
        return _read_hlo(text, hd)

    got = {}
    pod = M.make_production_mesh()
    for arch, kind in LAYERS:
        cfg = configs.get_config(arch)
        shapes = _shapes(cfg)
        specs = {k: tuple(M.param_spec(pod, "attn/" + k, s))
                 for k, s in shapes.items()}
        got[f"{arch}/{kind}"] = compile_layer(
            pod, shapes, specs, cfg.n_heads, cfg.n_kv, cfg.hd,
            frames=cfg.n_frames if kind == "cross" else None)
    four = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    for case, (h, kv, hd, d) in ATTN_CASES.items():
        specs = attn_specs(h, kv, hd, d, param_spec=lambda k, s: (
            M.param_spec(four, k, s)))
        shapes = {"wq": (d, h * hd), "wk": (d, kv * hd),
                  "wv": (d, kv * hd), "wo": (h * hd, d)}
        got[f"case/{case}"] = compile_layer(four, shapes, specs, h, kv, hd)
    with open(os.path.join(out_dir, "ref.json"), "w") as fh:
        json.dump(got, fh)


def _port(out_dir, rank):
    import torch
    import torch.distributed as tdist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L
    tdist.init_process_group("fake", store=FakeStore(), rank=rank,
                             world_size=256)
    mesh = M.make_production_mesh(device_type="cpu")
    got = {}
    for arch, kind in LAYERS:
        cfg = configs.get_config(arch)
        counter = dryrun.RankCounter(mesh)
        with FakeTensorMode(allow_non_fake_inputs=True), \
                implicit_replication():
            p = {k: M.distribute(torch.empty(s), M.NamedSharding(
                mesh, M.param_spec(mesh, "attn/" + k, s)))
                for k, s in _shapes(cfg).items()}

            def batch(n):
                return M.distribute(torch.empty(BATCH, n, cfg.d_model),
                                    M.NamedSharding(mesh, M.Spec("data")))
            x, pos = batch(SEQ), torch.arange(SEQ)
            kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd)
            if kind == "cross":
                enc = batch(cfg.n_frames)
                kw.update(causal=False, cross_kv=(
                    enc @ p["wk"], enc @ p["wv"], torch.arange(cfg.n_frames)))
            with counter, L.recording_blocks() as blocks:
                L.attn_apply(p, x, pos, **kw)
        got[f"{arch}/{kind}"] = {
            "blocks": [list(b) for b in blocks], "coll": counter.coll,
            "counts": {str(k): int(v) for k, v in
                       counter.comm.get_comm_counts().items()}}
    with open(os.path.join(out_dir, f"port{rank}.json"), "w") as fh:
        json.dump(got, fh)


def _run(*args, devices=None):
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(here, "..", "src"), here, env.get("PYTHONPATH", "")])
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             *map(str, args)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    where = tmp_path_factory.mktemp("heads")
    procs = [_run("ref", where, devices=256)] + [_run("port", where, r)
                                                 for r in RANKS]
    try:
        errors = [p.communicate(timeout=TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, err in zip(procs, errors):
        assert p.returncode == 0, err[-3000:]
    got = {}
    for name in ["ref"] + [f"port{r}" for r in RANKS]:
        with open(where / f"{name}.json") as fh:
            got[name] = json.load(fh)
    return got


@pytest.mark.parametrize("arch,kind", LAYERS)
def test_pod_blocks_match_the_reference(out, arch, kind):
    """Every rank runs the block that the reference's compiled program
    gives each device: starcoder2-7b 9 heads on 32 lanes (the scores
    summed over groups of 4), recurrentgemma-2b 5 heads, whisper-tiny 3 in
    self- and cross-attention, the others their heads over 16."""
    ref = out["ref"][f"{arch}/{kind}"]
    for r in RANKS:
        assert out[f"port{r}"][f"{arch}/{kind}"]["blocks"] == [ref], r


@pytest.mark.parametrize("case", [pytest.param(c, id=c) for c in ATTN_CASES])
def test_model_axis_of_four_matches_the_reference(out, case):
    """``test_torch_mesh_train.ATTN_EXTENTS``, the blocks that its 4 gloo
    ranks are held to, are the reference's on a model axis of 4."""
    assert list(ATTN_EXTENTS[case]) == out["ref"][f"case/{case}"]


def test_lane_collectives_count_on_the_model_axis(out):
    """starcoder2-7b's split head dim: the score products' all-reduce and
    the output's all-gather run over a group of 4 model ranks, which the
    dry run's counter puts on the model axis (``CommDebugMode`` counts
    both); nothing lands on an unknown axis.  The scores are f32 [1, 1, 9,
    256, 256] on rank 0: 2,359,296 bytes of its model all-reduce."""
    got = out["port0"]["starcoder2-7b/self"]
    assert set(got["coll"]) <= {"data", "model"}, got["coll"]
    assert got["coll"]["model"]["all-reduce"] >= 9 * SEQ * SEQ * 4
    assert got["coll"]["model"]["all-gather"] >= SEQ * 9 * 128 * 4
    assert got["counts"]["c10d_functional.all_reduce"] >= 1, got["counts"]


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        _reference(sys.argv[2])
    else:
        _port(sys.argv[2], int(sys.argv[3]))
