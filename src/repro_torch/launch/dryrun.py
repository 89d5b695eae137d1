"""Analytic paged-serving budget for mesh-sharded serving (port of the
``--paged-budget`` part of ``repro/launch/dryrun.py``): pure sharding
arithmetic over an :class:`~repro_torch.launch.mesh.AbstractMesh`, no
device and no process group.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --paged-budget --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --paged-budget \\
        --arch llama3-405b --kv-dtype int8 --mesh-shape 4,8 --out results/

Per device it gives the bytes of the weights, of the fixed cache state and
of one KV page under the *resolved* shardings of the paged engine
(``runtime.sharding.paged_engine_shardings`` on the ``meta`` parameter
tree and cache), so a divisibility fallback costs what it costs; the HBM
left over becomes the largest page pool. The interconnect side is the
first-order decode floor: every block's d_model all-reduce at the ring
convention (2x the operand bytes) over one link direction.

The constants are an H100's: ``HBM_PER_CHIP`` is the H100 80GB HBM3's
published 80e9 bytes, ``LINK_BW`` NVLink 4's 450e9 bytes/s a direction
(900 GB/s counts both). A model axis wider than one 8-GPU node crosses the
network between nodes, which this floor does not model. The port's page
pools carry one write-sink page beyond ``num_blocks``
(``sink_page_bytes_per_dev``), which the budget subtracts too.

The rest of the reference's dry run (``run_cell``: lower, compile and
analyse every (arch x shape x mesh) cell) analyses XLA HLO and is not
ported: it exits with that message.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: bytes of HBM per card (H100 80GB HBM3, published capacity)
HBM_PER_CHIP = 80e9
#: bytes/s one NVLink 4 direction moves (900 GB/s counts both)
LINK_BW = 450e9

#: default targets for --paged-budget: the three production-scale serving
#: archs whose KV pools the mesh-sharded engine is meant to hold
BUDGET_ARCHS = ("llama3-405b", "dbrx-132b", "jamba-1.5-large-398b")

_NOT_PORTED = "not ported: the compiled dry run analyses XLA HLO (use --paged-budget)"


def _pairs(tree, specs):
    """(tensor, spec) pairs of a cache-shaped tree and its specs."""
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    else:
        for v, s in zip(tree, specs):
            yield from _pairs(v, s)


def _sharded_bytes(pairs, mesh) -> float:
    """Per-device bytes of (tensor, spec) pairs: each tensor divided by the
    product of the axis sizes its spec uses (a replicated one by 1, so
    divisibility fallbacks surface as real budget)."""
    from repro_torch.runtime.sharding import spec_axes

    total = 0.0
    for t, spec in pairs:
        factor = 1
        for entry in spec:
            factor *= mesh.axes_size(spec_axes(entry))
        total += t.numel() * t.element_size() / factor
    return total


def paged_budget(arch: str, mesh, mesh_label: str, *, block_size: int = 64,
                 num_slots: int = 64, kv_dtype: str = "act") -> dict:
    """The reference's budget record for ``arch`` on ``mesh`` (an abstract
    mesh), with the card's constants. The page's per-device cost is the
    difference between a 2-page and a 1-page cache (pool leaves and the
    allocator's per-page leaves scale with ``num_blocks``, recurrent state
    and admin leaves do not); the fixed cost is a 0-page cache without its
    sink page."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.transformer import abstract_params, init_paged_cache, is_kv_pool
    from repro_torch.runtime.sharding import paged_engine_shardings

    cfg = get_config(arch)
    model = abstract_params(cfg)
    max_pages = -(-cfg.max_seq_len // block_size)
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())

    def cache_bytes_per_dev(num_blocks: int):
        cache = init_paged_cache(cfg, num_slots, num_blocks, block_size, max_pages,
                                 kv_dtype=None if kv_dtype == "act" else kv_dtype,
                                 device="meta")
        p_sh, c_sh = paged_engine_shardings(model, cache, cfg, mesh)
        sink = _sharded_bytes(
            (pair for pool, sp in zip(cache["pools"], c_sh["pools"]) if is_kv_pool(pool)
             for pair in _pairs(pool, sp)), mesh) / (num_blocks + 1)
        return _sharded_bytes(_pairs(cache, c_sh), mesh), sink, p_sh

    b0, sink, p_sh = cache_bytes_per_dev(0)
    b1, _, _ = cache_bytes_per_dev(1)
    b2, _, _ = cache_bytes_per_dev(2)
    page_bytes_per_dev = b2 - b1
    fixed_cache_bytes_per_dev = b0 - sink
    weight_bytes_per_dev = _sharded_bytes(((tensors[n], s) for n, s in p_sh.items()), mesh)

    kv_budget = HBM_PER_CHIP - weight_bytes_per_dev - fixed_cache_bytes_per_dev - sink
    max_blocks = int(kv_budget // page_bytes_per_dev) if kv_budget > 0 else 0
    # decode interconnect floor: one d_model all-reduce per block output,
    # 2x operand wire bytes (ring reduce-scatter + all-gather)
    n_blocks_model = cfg.repeats * len(cfg.pattern)
    act_bytes = torch.empty((), dtype=torch_dtype(cfg.act_dtype)).element_size()
    wire_per_tok = 2.0 * n_blocks_model * cfg.d_model * act_bytes
    return {
        "arch": arch,
        "mesh": mesh_label,
        "mesh_shape": dict(mesh.shape),
        "chips": int(mesh.size),
        "block_size": block_size,
        "num_slots": num_slots,
        "kv_dtype": kv_dtype,
        "hbm_per_chip_bytes": HBM_PER_CHIP,
        "weight_bytes_per_dev": weight_bytes_per_dev,
        "fixed_cache_bytes_per_dev": fixed_cache_bytes_per_dev,
        "sink_page_bytes_per_dev": sink,
        "kv_page_bytes_per_dev": page_bytes_per_dev,
        "kv_hbm_budget_per_dev": max(kv_budget, 0.0),
        "max_pool_blocks": max_blocks,
        "pool_token_capacity": max_blocks * block_size,
        "max_concurrent_max_seq": (max_blocks // max_pages) if max_pages else 0,
        "fits": bool(max_blocks >= 1),
        "interconnect": {
            "decode_wire_bytes_per_tok_per_dev": wire_per_tok,
            "decode_ici_floor_us_per_tok": float(np.float64(1e6) * wire_per_tok / LINK_BW),
            "link_bytes_per_s": LINK_BW,
        },
    }


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", type=str, default=None, help=_NOT_PORTED)
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--mesh-shape", type=str, default=None,
                    help="override, e.g. '2,4' or '2,2,2'")
    ap.add_argument("--all", action="store_true", help=_NOT_PORTED)
    ap.add_argument("--quantized", action="store_true", help=_NOT_PORTED)
    ap.add_argument("--paged-budget", action="store_true",
                    help="analytic mesh-sharded paged-serving HBM/link budgets for --arch or "
                         f"the production serving archs {BUDGET_ARCHS}")
    ap.add_argument("--kv-dtype", choices=("act", "int8"), default="act",
                    help="page pool element type for --paged-budget")
    ap.add_argument("--block-size", type=int, default=64, help="page size for --paged-budget")
    ap.add_argument("--out", type=str, default=None, help="output dir for JSON")
    args = ap.parse_args(argv)
    if not args.paged_budget or args.shape or args.all or args.quantized:
        raise SystemExit(_NOT_PORTED)

    meshes = []
    if args.mesh_shape:
        shape = tuple(int(x) for x in args.mesh_shape.split(","))
        meshes.append((make_mesh(shape, abstract=True), args.mesh_shape))
    else:
        if args.mesh in ("single", "both"):
            meshes.append((make_production_mesh(multi_pod=False, abstract=True), "single"))
        if args.mesh in ("multi", "both"):
            meshes.append((make_production_mesh(multi_pod=True, abstract=True), "multi"))

    failures = 0
    for arch in (args.arch,) if args.arch else BUDGET_ARCHS:
        for mesh, label in meshes:
            try:
                b = paged_budget(arch, mesh, label, block_size=args.block_size,
                                 kv_dtype=args.kv_dtype)
            except Exception as e:  # noqa: BLE001 - reported and counted, as the reference
                failures += 1
                print(f"[dryrun] FAIL paged-budget {arch}|{label}: {type(e).__name__}: {e}")
                continue
            verdict = "OK  " if b["fits"] else "OOM "
            if not b["fits"]:
                failures += 1
            print(f"[dryrun] {verdict}paged-budget {arch}|{label}  "
                  f"weights={b['weight_bytes_per_dev'] / 1e9:.1f}GB/dev "
                  f"pool={b['max_pool_blocks']}blocks({b['pool_token_capacity']}tok) "
                  f"link_floor={b['interconnect']['decode_ici_floor_us_per_tok']:.0f}us/tok")
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                fname = f"{arch}__paged_budget__{label}.json".replace("/", "_")
                with open(os.path.join(args.out, fname), "w") as f:
                    json.dump(b, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
