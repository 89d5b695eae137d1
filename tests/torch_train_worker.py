"""One rank of the mesh training tests (``tests/test_torch_mesh_training.py``).

    python tests/torch_train_worker.py --rank R --world N --init file:///tmp/x/rdv \\
        --params params.pkl --ckpt-root DIR --out out_R.pkl --cases a,b

Each rank joins a gloo group through ``--init`` (a ``file://`` rendezvous)
and runs the cases in order, each on its own mesh of the same ranks
(:data:`CASES`): the reference's parameters (pickled numpy trees, one an
arch) carried into the port with ``interop.params_from_numpy``, the train
state placed on the mesh, :data:`STEPS` steps on the rank's rows of each
global batch; it records every step's metrics and the whole train state
(gathered, in the reference's layout) after steps 1 and 8, the most bytes
of gathered parameters alive at once in a step beside each unit's whole
bytes, and the placed state's bytes beside ``mesh_train_bytes``. The checkpoint
cases write a placed state's checkpoint from the ranks (``ckpt_out``) and
restore a one-device checkpoint onto the mesh (``ckpt_in``); ``gather_order``
holds the NCCL form of a gather to the gloo form. No JAX.
"""

from __future__ import annotations

import argparse
import math
import os
import pickle
import sys
import traceback
from dataclasses import replace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

import torch  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.data import DataConfig, TokenBatcher  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.transformer import model_units  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    TrainRunConfig,
    gather_train_state,
    init_train_state,
    make_train_step,
    place_train_state,
    steps,
)

STEPS = 8
#: the steps after which the whole train state is recorded
HELD = (1, 8)
#: the checkpoint cases' step to write (or restore) and the step they reach
CKPT_AT, CKPT_END = 3, 5
#: name: (arch, (pod, data, model), grad_compression, microbatches); an
#: arch ``name/L-remat`` or ``name/remat`` is :func:`config`'s variant
CASES = {
    "dense_1x2x1": ("smollm-360m", (1, 2, 1), "none", 1),
    "dense_1x1x2": ("smollm-360m", (1, 1, 2), "none", 1),
    "micro_1x2x1": ("smollm-360m", (1, 2, 1), "none", 4),
    "moe_1x2x1": ("tiny-moe", (1, 2, 1), "none", 1),
    "xlstm_1x2x1": ("tiny-xlstm", (1, 2, 1), "none", 1),
    "dense_2x2x1": ("smollm-360m", (2, 2, 1), "none", 1),
    "int8_2x1x2": ("smollm-360m", (2, 1, 2), "int8-pod", 1),
    "remat_1x2x2": ("smollm-360m/4-block", (1, 2, 2), "none", 2),
    "moe_remat_1x2x1": ("tiny-moe/block", (1, 2, 1), "none", 1),
}
#: int8-pod with data > 1 inside a pod: each rank's gradient reaches the
#: compression as its slice of the leaf (held in a test of its own)
SLICE_CASES = {"int8_2x2x1": ("smollm-360m", (2, 2, 1), "int8-pod", 1)}
#: the checkpoint cases' mesh
CKPT_MESH = (1, 2, 1)
ARCHS = sorted({c[0] for c in (CASES | SLICE_CASES).values()})


def config(arch: str):
    """The test's config of ``arch``: the 2-layer smollm smoke of
    ``tests/test_torch_training.py``, or a per-family rung; vocab 64, and
    tiny-moe's routing groups of 32 tokens, so that a rank's 64 tokens on
    (1, 2, 1) are whole groups. ``arch/L-remat`` scales it to L layers
    and ``remat``, ``arch/remat`` to ``remat``."""
    arch, _, variant = arch.partition("/")
    if arch == "smollm-360m":
        cfg = get_smoke(arch).scaled(n_layers=2, vocab=64, remat="none")
    else:
        cfg = get_config(arch).scaled(vocab=64)
        cfg = cfg.scaled(moe=replace(cfg.moe, group_size=32)) if cfg.moe else cfg
    if variant:
        *layers, remat = variant.split("-")
        cfg = cfg.scaled(remat=remat, **({"n_layers": int(layers[0])} if layers else {}))
    return cfg


def data() -> TokenBatcher:
    return TokenBatcher(DataConfig(vocab=64, seq_len=16, global_batch=8))


def run_config(compression: str = "none", microbatches: int = 1) -> TrainRunConfig:
    return TrainRunConfig(num_microbatches=microbatches, grad_compression=compression)


def rows(mesh, batch: np.ndarray) -> torch.Tensor:
    """This rank's block of a global batch under the ``batch`` rule."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    per = batch.shape[0] // mesh.axes_size(axes)
    i = mesh.index(axes)
    return torch.from_numpy(np.asarray(batch[i * per:(i + 1) * per]))


def _train(mesh, state, step, lo: int, hi: int, out: dict | None = None) -> dict:
    d = data()
    for i in range(lo, hi):
        steps.reset_gathered()
        state, m = step(state, {"tokens": rows(mesh, d.batch(i)["tokens"])})
        if out is not None:
            out["gathered_peak"] = max(out.get("gathered_peak", 0), steps.gathered_peak)
            for k in ("loss", "ce", "aux", "ppl", "grad_norm", "lr"):
                out.setdefault(k, []).append(float(m[k]))
            if i + 1 in HELD:
                out[f"state{i + 1}"] = interop.train_state_to_numpy(gather_train_state(state))
    return state


def run_case(ctx, name: str) -> dict:
    arch, shape, comp, n_mb = (CASES | SLICE_CASES)[name]
    mesh = make_mesh(shape, **ctx["init"])
    cfg, run = config(arch), run_config(comp, n_mb)
    model = interop.params_from_numpy(ctx["params"][arch], cfg, device="cpu")
    state = place_train_state(init_train_state(cfg, run, model=model), mesh)
    out = {"held": {n: tuple(p.shape) for n, p in state["params"].named_parameters()},
           "state_bytes": sum(t.numel() * t.element_size() for t in [
               *state["params"].parameters(), *state["opt"]["m"].values(),
               *state["opt"]["v"].values(), state["opt"]["step"]]),
           "grad_bytes": sum(p.numel() * p.element_size()
                             for p in state["params"].parameters()),
           "bytes": steps.mesh_train_bytes(cfg, run, mesh),
           "units": {f"{u.kind}{u.index}": sum(_full_bytes(state, n) for n in u.names)
                     for u in model_units(state["params"])},
           "leaves": {n: _full_bytes(state, n) for n in ("embedding.embed", "embedding.head")
                      if n in state["params"]._train_specs},
           "tree_bytes": sum(_full_bytes(state, n) for n in state["params"]._train_specs)}
    _train(mesh, state, make_train_step(cfg, run, mesh), 0, STEPS, out)
    return out


def _full_bytes(state, name: str) -> int:
    """Bytes of the whole leaf ``name`` of a placed state."""
    model = state["params"]
    p = dict(model.named_parameters())[name]
    return math.prod(steps.full_shape(p, model._train_specs[name], model._mesh)) * p.element_size()


def ckpt_out(ctx) -> dict:
    """The dense case's state placed on (1, 2, 1): CKPT_AT steps, a
    checkpoint written from the ranks, then on to CKPT_END."""
    mesh = make_mesh(CKPT_MESH, **ctx["init"])
    cfg, run = config("smollm-360m"), run_config()
    model = interop.params_from_numpy(ctx["params"]["smollm-360m"], cfg, device="cpu")
    state = place_train_state(init_train_state(cfg, run, model=model), mesh)
    step = make_train_step(cfg, run, mesh)
    state = _train(mesh, state, step, 0, CKPT_AT)
    tree = interop.train_state_tree(state)  # gathered on every rank
    if mesh.rank == 0:
        CheckpointManager(os.path.join(ctx["ckpt_root"], "two")).save(CKPT_AT, tree,
                                                                        blocking=True)
    state = _train(mesh, state, step, CKPT_AT, CKPT_END)
    return {"end": interop.train_state_to_numpy(gather_train_state(state))}


def ckpt_in(ctx) -> dict:
    """A one-device checkpoint (written by the test at CKPT_AT) restored
    onto (1, 2, 1), each rank taking its slice, then on to CKPT_END."""
    mesh = make_mesh(CKPT_MESH, **ctx["init"])
    cfg, run = config("smollm-360m"), run_config()
    state = place_train_state(init_train_state(cfg, run, seed=1, device="cpu"), mesh)
    mgr = CheckpointManager(os.path.join(ctx["ckpt_root"], "one"))
    at, tree, _ = mgr.restore_latest(interop.train_state_tree(state, spec=True))
    interop.load_train_state_(state, tree)
    restored = interop.train_state_to_numpy(gather_train_state(state))
    state = _train(mesh, state, make_train_step(cfg, run, mesh), at, CKPT_END)
    return {"at": at, "restored": restored,
            "end": interop.train_state_to_numpy(gather_train_state(state))}


def gather_order(ctx) -> dict:
    """``all_gather_into_tensor``'s gather (the NCCL form; gloo runs it too)
    against the bitwise-sum gather on a (2, 2) mesh, for every axes order
    and dim: the blocks in shard order, the first axis major."""
    from repro_torch.runtime import collectives

    mesh = make_mesh((2, 2), **ctx["init"])
    out = {}
    for axes in (("data",), ("model",), ("data", "model"), ("model", "data")):
        for dim in (0, 1):
            x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 100 * mesh.index(axes)
            want = collectives.gather_dim(x, dim, mesh, axes)  # gloo: the bitwise sum
            got = collectives._all_gather(x, dim, mesh, axes)
            out[f"{'+'.join(axes)}/{dim}"] = bool(torch.equal(got, want))
    return out


EXTRA = {"ckpt_out": ckpt_out, "ckpt_in": ckpt_in, "gather_order": gather_order}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--params", required=True, help="pickled {arch: numpy parameter tree}")
    ap.add_argument("--ckpt-root", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cases", required=True)
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds a collective waits for the other ranks")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    with open(args.params, "rb") as f:
        params = pickle.load(f)
    ctx = {"params": params, "ckpt_root": args.ckpt_root,
           "init": dict(device="cpu", init_method=args.init, rank=args.rank,
                        world_size=args.world, timeout=args.timeout)}
    results, rc = {}, 0
    for name in args.cases.split(","):
        try:
            results[name] = EXTRA[name](ctx) if name in EXTRA else run_case(ctx, name)
        except Exception:  # noqa: BLE001 - the test reports it
            results[name] = {"error": traceback.format_exc()}
            rc = 1
    with open(args.out, "wb") as f:
        pickle.dump(results, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    sys.exit(main())
