"""Port parity of the analytic paged-serving budget (``repro_torch.launch.
dryrun --paged-budget``) and of the dry run's shape stand-ins
(``repro_torch.configs.shapes``) against the reference. The reference's
budget runs as its CLI in a subprocess, as ``tests/test_dryrun.py`` runs it
(importing ``repro.launch.dryrun`` would set ``XLA_FLAGS`` in this
process). The HBM and link constants differ by design (an H100's, not a
v5e's); the sharding-derived bytes must be equal exactly.
"""

import json
import os
import subprocess
import sys

import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import applicable as j_applicable
from repro.configs import batch_specs as j_batch_specs
from repro.configs import cache_specs as j_cache_specs
from repro.configs import get_config as j_get_config
from repro_torch.configs import ARCH_IDS, SHAPES, applicable, batch_specs, cache_specs, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = ("weight_bytes_per_dev", "fixed_cache_bytes_per_dev", "kv_page_bytes_per_dev")


def _sd(x):
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_specs_match_reference(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    assert tuple(SHAPES) == tuple(J_SHAPES)
    for name, shape in SHAPES.items():
        assert shape == type(shape)(**vars(J_SHAPES[name]))
        assert applicable(cfg, shape) == j_applicable(jcfg, J_SHAPES[name])
        if not applicable(cfg, shape):
            continue
        want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                j_batch_specs(jcfg, J_SHAPES[name]).items()}
        got = batch_specs(cfg, shape)
        assert all(t.is_meta for t in got.values())
        assert {k: _sd(v) for k, v in got.items()} == want
        if shape.kind != "decode":
            continue
        jc = j_cache_specs(jcfg, J_SHAPES[name])
        pc = cache_specs(cfg, shape)
        assert len(pc) == cfg.n_layers
        for i, layer in enumerate(pc):
            ref = jc[i % cfg.period]
            assert set(layer) == set(ref)
            for k, t in layer.items():
                assert t.is_meta
                assert _sd(t) == (tuple(ref[k].shape[1:]), str(ref[k].dtype)), (i, k)


def _reference_budget(tmp_path, kv_dtype):
    out = str(tmp_path / f"ref_{kv_dtype}")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_DRYRUN_XLA_FLAGS="--xla_force_host_platform_device_count=256")
    r = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--paged-budget", "--mesh",
                        "single", "--kv-dtype", kv_dtype, "--out", out],
                       capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return {arch: json.load(open(os.path.join(out, f"{arch}__paged_budget__single.json")))
            for arch in dryrun.BUDGET_ARCHS}


@pytest.mark.parametrize("kv_dtype", ["act", "int8"])
def test_paged_budget_bytes_match_reference(tmp_path, kv_dtype):
    ref = _reference_budget(tmp_path, kv_dtype)
    mesh = make_production_mesh(abstract=True)
    for arch in dryrun.BUDGET_ARCHS:
        got = dryrun.paged_budget(arch, mesh, "single", kv_dtype=kv_dtype)
        want = ref[arch]
        for key in EXACT:
            assert got[key] == want[key], (arch, key, got[key], want[key])
        wire = "decode_wire_bytes_per_tok_per_dev"
        assert got["interconnect"][wire] == want["interconnect"][wire]
        assert got["chips"] == want["chips"] == 256
        assert got["mesh_shape"] == want["mesh_shape"]
        assert set(want) <= set(got) and set(want["interconnect"]) <= set(got["interconnect"])
        assert got["hbm_per_chip_bytes"] == 80e9 and got["fits"]
        assert got["sink_page_bytes_per_dev"] > 0
        budget = 80e9 - got["weight_bytes_per_dev"] - got["fixed_cache_bytes_per_dev"] \
            - got["sink_page_bytes_per_dev"]
        assert got["max_pool_blocks"] == int(budget // got["kv_page_bytes_per_dev"])


def test_paged_budget_cli(tmp_path, capsys):
    assert dryrun.main(["--paged-budget", "--mesh", "single", "--out", str(tmp_path)]) == 0
    rec = json.load(open(tmp_path / "llama3-405b__paged_budget__single.json"))
    assert rec["fits"] and rec["chips"] == 256
    assert dryrun.main(["--paged-budget", "--arch", "llama3-405b", "--kv-dtype", "int8",
                        "--mesh", "single", "--out", str(tmp_path)]) == 0
    rec8 = json.load(open(tmp_path / "llama3-405b__paged_budget__single.json"))
    assert rec8["max_pool_blocks"] > rec["max_pool_blocks"]  # int8 pages halve a page
    # 8 cards cannot hold 405B weights: the budget says OOM and exits 1
    assert dryrun.main(["--paged-budget", "--arch", "llama3-405b", "--mesh-shape", "2,4"]) == 1
    assert "OOM" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="not ported: the compiled dry run analyses XLA HLO"):
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k"])
