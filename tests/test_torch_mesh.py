"""The sharding policy (``launch/mesh.py``) and the mesh helpers of
``core/dist.py`` against the reference's, on both production meshes.

The reference runs once, in a subprocess with 512 forced host devices: for
every leaf of every ``configs.ARCHS`` config (shapes through
``jax.eval_shape``, nothing compiled) on the (16, 16) and (2, 16, 16)
meshes, its ``param_spec`` and ``NamedSharding(...).devices_indices_map``
(each device's index range, devices in mesh-coordinate order); its
``batch_spec`` and ``cache_spec`` of every shape's inputs; and
``state_shardings`` of reduced starcoder2 under artemis with adam on both
wires (the leaf wire on the multi-pod mesh alone: on one pod its worker
axis, ``data``, already splits the parameters, and the reference raises).  The port runs in one subprocess per mesh, each on a fake process
group of 256 or 512 ranks (a process's default group is global): its
specs, and every rank's index range from DTensor's own local shape and
offset (``_index_ranges``), must equal the reference's exactly; so must
its state specs.  The same subprocess runs the dry run of reduced
starcoder2's train step on the pod mesh, whose per-rank parameter bytes
must be the sum of the reference's shard shapes on rank 0.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

MESHES = ("pod", "multipod")
ARCHS = ("whisper-tiny", "olmoe-1b-7b", "minitron-8b", "falcon-mamba-7b",
         "nemotron-4-15b", "llava-next-mistral-7b", "mixtral-8x22b",
         "recurrentgemma-2b", "mistral-large-123b", "starcoder2-7b")
# (mesh, wire) of the state shardings: the leaf wire shifts a parameter's
# spec onto the worker axis, which the single pod's parameters already
# use (the reference raises DuplicateSpecError there)
STATE_CASES = (("pod", "bucketed"), ("multipod", "bucketed"),
               ("multipod", "leaf"))
STATE_ARCH = "starcoder2-7b"            # reduced, for the state shardings
DRY = dict(batch=32, seq=64)            # the dry run's reduced train step
TIMEOUT = 300


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts, lists and tuples (dict keys sorted)."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _index_ranges(mesh_shape, placements, shape):
    """Every rank's global index range of a tensor of ``shape`` placed by
    ``placements`` on a mesh of ``mesh_shape``, ranks in mesh-coordinate
    order: DTensor's own local shape and offset for each coordinate."""
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset)
    out = []
    for coord in np.ndindex(*mesh_shape):
        local, offset = _compute_local_shape_and_global_offset(
            tuple(shape), tuple(mesh_shape), list(coord), placements)
        out.append(tuple((o, o + n) for o, n in zip(offset, local)))
    return out


# ---------------------------------------------------------------------------
# the reference (512 host devices) and the port (a fake group), as scripts
# ---------------------------------------------------------------------------

def _reference(out_dir):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.core import dist
    from repro.launch import mesh as M
    from repro.models.model import build_model
    from repro.optim import adam
    assert jax.device_count() == 512, jax.devices()
    specs, ranges = {}, {}
    for kind in MESHES:
        mesh = M.make_production_mesh(multi_pod=kind == "multipod")
        coords = list(np.ndindex(mesh.devices.shape))
        for arch in ARCHS:
            cfg = configs.get_config(arch)
            model = build_model(cfg)
            params = _flat(jax.eval_shape(model.init, jax.random.PRNGKey(0)))
            for k, leaf in params.items():
                spec = M.param_spec(mesh, k, leaf.shape)
                specs[f"{kind}/{arch}/param/{k}"] = _spec_json(spec)
                imap = NamedSharding(mesh, spec).devices_indices_map(
                    leaf.shape)
                ranges[f"{kind}/{arch}/{k}"] = np.array(
                    [[(s.start or 0, leaf.shape[d] if s.stop is None
                       else s.stop) for d, s in enumerate(
                        imap[mesh.devices[c]])] for c in coords],
                    dtype=np.int64).reshape(len(coords), len(leaf.shape), 2)
                specs[f"{kind}/{arch}/shape/{k}"] = list(leaf.shape)
            for name, shape in configs.SHAPES.items():
                if configs.applicable(cfg, shape):
                    continue
                inputs = configs.input_specs(cfg, shape, model)
                if shape.kind == "decode":
                    for k, leaf in _flat(inputs["cache"]).items():
                        specs[f"{kind}/{arch}/{name}/cache/{k}"] = _spec_json(
                            M.cache_spec(mesh, k, leaf.shape))
                    inputs = {k: v for k, v in inputs.items()
                              if k in ("token", "enc_out")}
                for k, leaf in inputs.items():
                    specs[f"{kind}/{arch}/{name}/batch/{k}"] = _spec_json(
                        M.batch_spec(mesh, leaf.shape))
        cfg = configs.get_config(STATE_ARCH, reduced=True)
        model = build_model(cfg)
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        pshard = M.params_shardings(mesh, params)
        for k, leaf in _flat(params).items():
            imap = NamedSharding(mesh, M.param_spec(
                mesh, k, leaf.shape)).devices_indices_map(leaf.shape)
            first = imap[mesh.devices[coords[0]]]
            specs[f"{kind}/reduced/rank0/{k}"] = [
                (leaf.shape[d] if s.stop is None else s.stop) - (s.start or 0)
                for d, s in enumerate(first)] + [leaf.dtype.itemsize]
        waxes = ("pod",) if kind == "multipod" else ("data",)
        for wire in (w for m, w in STATE_CASES if m == kind):
            dcfg = dist.DistConfig(worker_axes=waxes, variant="artemis",
                                   wire=wire)
            init_state, _ = dist.make_train_step(model, adam(1e-3), dcfg,
                                                 mesh)
            with jax.set_mesh(mesh):
                state = jax.eval_shape(init_state, params)
            sh = dist.state_shardings(mesh, state, pshard, dcfg)
            specs[f"{kind}/state/{wire}"] = [
                _spec_json(ns.spec) for ns in jax.tree.leaves(sh)]
            specs[f"{kind}/state_specs/{wire}"] = [
                _spec_json(sp) for sp in jax.tree.leaves(
                    dist.state_specs(dcfg, state),
                    is_leaf=lambda x: isinstance(x, P))]
    with open(os.path.join(out_dir, "ref.json"), "w") as fh:
        json.dump(specs, fh)
    np.savez(os.path.join(out_dir, "ref.npz"), **ranges)


def _port(out_dir, kind):
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import configs
    from repro_torch.core import dist
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.models.model import build_model, flatten_params
    from repro_torch.optim import adam
    dryrun._fake_group(dryrun.MESH_RANKS[kind])
    mesh = M.make_production_mesh(multi_pod=kind == "multipod",
                                  device_type="cpu")
    mesh_shape = tuple(mesh.size(i) for i in range(mesh.ndim))
    specs, ranges = {}, {}
    for arch in ARCHS:
        cfg = configs.get_config(arch)
        model = build_model(cfg)
        with FakeTensorMode():
            params = model.init(torch.Generator())
        for k, leaf in params.items():
            spec = M.param_spec(mesh, k, tuple(leaf.shape))
            specs[f"{kind}/{arch}/param/{k}"] = _spec_json(spec)
            specs[f"{kind}/{arch}/shape/{k}"] = list(leaf.shape)
            ranges[f"{kind}/{arch}/{k}"] = np.array(_index_ranges(
                mesh_shape, M.to_placements(mesh, spec), tuple(leaf.shape)),
                dtype=np.int64).reshape(-1, leaf.dim(), 2)
        for name, shape in configs.SHAPES.items():
            if configs.applicable(cfg, shape):
                continue
            inputs = configs.input_specs(cfg, shape, model)
            if shape.kind == "decode":
                for k, leaf in flatten_params(inputs["cache"]).items():
                    specs[f"{kind}/{arch}/{name}/cache/{k}"] = _spec_json(
                        M.cache_spec(mesh, k, tuple(leaf.shape)))
                inputs = {k: v for k, v in inputs.items()
                          if k in ("token", "enc_out")}
            for k, leaf in inputs.items():
                specs[f"{kind}/{arch}/{name}/batch/{k}"] = _spec_json(
                    M.batch_spec(mesh, tuple(leaf.shape)))
    cfg = configs.get_config(STATE_ARCH, reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    pshard = M.params_shardings(mesh, params)
    waxes = ("pod",) if kind == "multipod" else ("data",)
    for wire in (w for m, w in STATE_CASES if m == kind):
        dcfg = dist.DistConfig(worker_axes=waxes, variant="artemis",
                               wire=wire)
        plist = list(params.values())
        state = dist.TrainState(
            params=params, opt_state=adam(1e-3).init(plist),
            artemis=dist.init_dist_state(dcfg, plist, 1, device="cpu"),
            step=0)
        sh = dist.state_shardings(mesh, state, pshard, dcfg)
        specs[f"{kind}/state/{wire}"] = [
            _spec_json(ns.spec) for ns in flatten_params(sh).values()]
        specs[f"{kind}/state_specs/{wire}"] = [
            _spec_json(sp) for sp in _spec_leaves(
                dist.state_specs(dcfg, state))]
    if kind == "pod":
        specs["shard_map"] = _shard_map_case(mesh)
        rec = dryrun.lower_mesh(STATE_ARCH, "train_4k", "pod", reduced=True,
                                **DRY)
        specs["dryrun"] = {k: rec[k] for k in ("status", "param_bytes",
                                               "chips", "mesh")}
    with open(os.path.join(out_dir, f"{kind}.json"), "w") as fh:
        json.dump(specs, fh)
    np.savez(os.path.join(out_dir, f"{kind}.npz"), **ranges)


def _spec_leaves(tree):
    """The ``Spec`` leaves of a tree of dicts, lists, tuples and
    dataclasses, in flatten order."""
    import dataclasses
    from repro_torch.launch.mesh import Spec
    if isinstance(tree, Spec):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    return [leaf for sub in tree for leaf in _spec_leaves(sub)]


def _shard_map_case(mesh):
    """``shard_map_compat`` on the pod mesh: a [32, 64] DTensor split over
    (data, model), in and out specs over data, manual over data (the body
    sees a DTensor on the model axis, still split) and over both (the body
    sees a plain block, replicated over model)."""
    import torch
    from repro_torch.core import dist
    from repro_torch.launch import mesh as M
    x = M.distribute(torch.arange(32 * 64.0).reshape(32, 64),
                     M.NamedSharding(mesh, M.Spec("data", "model")))
    out = {}
    for manual in (("data",), ("data", "model")):
        seen = {}

        def body(t):
            seen["type"] = type(t).__name__
            seen["shape"] = list(t.shape)
            seen["placements"] = [str(p) for p in getattr(t, "placements",
                                                          ())]
            return t * 2
        y = dist.shard_map_compat(body, mesh, (M.Spec("data"),),
                                  M.Spec("data"), manual)(x)
        out["/".join(manual)] = {
            **seen, "out_shape": list(y.shape),
            "out_placements": [str(p) for p in y.placements],
            # no collective ran (a fake group's move nothing): this rank's
            # block, doubled
            "doubled": (len(manual) == 1 and bool(torch.equal(
                y.to_local(), 2 * x.to_local())))}
    return out


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
    where = tmp_path_factory.mktemp("mesh")
    procs = [_run("ref", where, devices=512)] + [_run("port", where, kind)
                                                 for kind in MESHES]
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
    for name in ("ref",) + MESHES:
        with open(where / f"{name}.json") as fh:
            got[name] = json.load(fh)
        got[name + "/ranges"] = dict(np.load(where / f"{name}.npz"))
    return got


def _keys(table, prefix):
    return sorted(k for k in table if k.startswith(prefix))


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(out, kind, arch):
    ref, got = out["ref"], out[kind]
    for what in ("param", "shape"):
        pre = f"{kind}/{arch}/{what}/"
        assert _keys(got, pre) == _keys(ref, pre)
        assert _keys(ref, pre)
        for k in _keys(ref, pre):
            assert got[k] == ref[k], k


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_index_ranges_match_the_reference(out, kind, arch):
    ref, got = out["ref/ranges"], out[kind + "/ranges"]
    pre = f"{kind}/{arch}/"
    assert _keys(got, pre) == _keys(ref, pre)
    for k in _keys(ref, pre):
        assert got[k].shape[0] == (512 if kind == "multipod" else 256)
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_the_reference(out, kind, arch):
    ref, got = out["ref"], out[kind]
    keys = [k for k in _keys(ref, f"{kind}/{arch}/")
            if "/batch/" in k or "/cache/" in k]
    assert keys
    assert [k for k in _keys(got, f"{kind}/{arch}/")
            if "/batch/" in k or "/cache/" in k] == keys
    for k in keys:
        assert got[k] == ref[k], k


@pytest.mark.parametrize("kind,wire", STATE_CASES)
@pytest.mark.parametrize("what", ["state", "state_specs"])
def test_state_shardings_match_the_reference(out, kind, wire, what):
    key = f"{kind}/{what}/{wire}"
    assert out[kind][key] == out["ref"][key]
    assert out[kind][key]


def test_shard_map_compat_hands_each_rank_its_block(out):
    got = out["pod"]["shard_map"]
    inner = got["data"]
    assert inner["type"] == "DTensor" and inner["shape"] == [2, 64]
    assert inner["placements"] == ["S(1)"] or inner["placements"] == [
        "Shard(dim=1)"]
    assert inner["doubled"]
    # every axis manual: the spec names data alone, so the block is
    # replicated over model, as shard_map's is
    local = got["data/model"]
    assert local["type"] == "Tensor" and local["shape"] == [2, 64]
    for case in got.values():
        assert case["out_shape"] == [32, 64]
        assert len(case["out_placements"]) == 2


def test_dryrun_rank_holds_the_references_shards(out):
    rec = out["pod"]["dryrun"]
    assert rec["status"] == "ok" and rec["chips"] == 256
    want = sum(int(np.prod(v[:-1])) * v[-1] for k, v in out["ref"].items()
               if k.startswith("pod/reduced/rank0/"))
    assert rec["param_bytes"] == want


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        _reference(sys.argv[2])
    else:
        _port(sys.argv[2], sys.argv[3])
