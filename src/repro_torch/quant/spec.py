"""The serving-datapath record :class:`DatapathSpec` (port of
``repro/quant/spec.py``).

AXE certifies that a site's integer codes never overflow a multi-stage
accumulator: K tiles of size T feed P_I-bit inner registers that drain into
a P_O-bit outer register (Eq. 22), against a specific activation quantizer.
The spec travels with every packed site (``PackedLinear.spec`` plus the
persistable ``spec_arr`` twin) and is the single source of the kernel's
accumulator knobs. :class:`AttnDatapathSpec` is the attention record: the
two integer reductions of paged decode attention over int8 KV pages.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, replace

import numpy as np
import torch

#: Current packed-artifact schema version.
ARTIFACT_VERSION = 2

#: Number of float64 slots in the array encoding (``to_array``); the 10-slot
#: pre-sparsity encoding still loads (as dense).
_SPEC_ARR_LEN = 11

#: ``sparsity`` slot encoding (NaN == dense).
_SPARSITY_CODES = {"2:4": 1.0}
_SPARSITY_NAMES = {v: k for k, v in _SPARSITY_CODES.items()}


class DatapathMismatchError(ValueError):
    """A packed artifact and a requested serving datapath disagree. Raised
    instead of silently preferring either side: a certificate for one
    (T, P_I) datapath served on another voids the overflow guarantee."""


@dataclass(frozen=True)
class DatapathSpec:
    """One site's certified serving datapath; defaults are the paper's LLM
    recipe (W4A8, unsigned asymmetric activations, T=128, P_I=16).
    ``act_scale``/``act_zp`` are the per-site record of a calibrated static
    activation quantizer; inside a packed site the numbers live in its
    ``act_scale``/``act_zp`` buffers and the spec keeps only ``static_act``
    (:meth:`leaf_spec`)."""

    w_bits: int = 4
    act_bits: int = 8
    act_signed: bool = False
    tile: int | None = 128  # the paper's T; None = monolithic accumulation
    p_inner: int = 16  # P_I (monolithic P when tile is None)
    p_outer: int = 32  # P_O of Eq. 22
    static_act: bool = False
    act_scale: float | None = None
    act_zp: int = 0
    version: int = ARTIFACT_VERSION
    sparsity: str | None = None

    def __post_init__(self) -> None:
        if self.sparsity is not None and self.sparsity not in _SPARSITY_CODES:
            raise ValueError(f"unknown sparsity pattern {self.sparsity!r}")

    # -- identity -----------------------------------------------------------
    def key(self) -> tuple:
        """The datapath identity. Calibration numerics and the per-site
        derived ``p_outer`` are excluded, as in the reference."""
        return (self.w_bits, self.act_bits, self.act_signed, self.tile,
                self.p_inner, self.static_act, self.sparsity)

    def spec_hash(self) -> str:
        payload = repr((self.key(), self.version)).encode()
        return hashlib.sha1(payload).hexdigest()[:12]

    def matches(self, other: "DatapathSpec") -> bool:
        return self.key() == other.key()

    def require_matches(self, other: "DatapathSpec", context: str = "") -> None:
        if not self.matches(other):
            where = f" ({context})" if context else ""
            raise DatapathMismatchError(
                f"datapath mismatch{where}: artifact certified for "
                f"{self.describe()} but {other.describe()} was requested. "
                f"Re-quantize for the requested datapath or drop the "
                f"override — serving a certificate on a different datapath "
                f"voids the overflow guarantee."
            )

    def describe(self) -> str:
        act = "static" if self.static_act else "dynamic"
        sign = "s" if self.act_signed else "u"
        t = self.tile if self.tile is not None else "mono"
        sp = f" sparsity={self.sparsity}" if self.sparsity is not None else ""
        return (f"W{self.w_bits}A{self.act_bits}{sign} T={t} "
                f"P_I={self.p_inner} P_O={self.p_outer} act={act} "
                f"v{self.version}{sp}")

    # -- derived forms ------------------------------------------------------
    def leaf_spec(self) -> "DatapathSpec":
        """The form a packed site keeps: calibration numerics dropped."""
        return replace(self, act_scale=None, act_zp=0)

    def with_act(self, scale: float, zero_point: int) -> "DatapathSpec":
        """This datapath with a calibrated static activation quantizer."""
        return replace(self, static_act=True, act_scale=float(scale), act_zp=int(zero_point))

    def block_k(self, default: int = 128) -> int:
        """The certified K tile; ``tile=None`` (monolithic) keeps the
        default tile, whose partials the full-K bound also covers."""
        return self.tile if self.tile else default

    # -- serialization ------------------------------------------------------
    def to_array(self) -> np.ndarray:
        """Encode as a float64 vector; NaN encodes None."""
        return np.asarray(
            [
                float(self.version),
                float(self.w_bits),
                float(self.act_bits),
                1.0 if self.act_signed else 0.0,
                float(self.tile) if self.tile is not None else np.nan,
                float(self.p_inner),
                float(self.p_outer),
                1.0 if self.static_act else 0.0,
                float(self.act_scale) if self.act_scale is not None else np.nan,
                float(self.act_zp),
                _SPARSITY_CODES.get(self.sparsity, np.nan),
            ],
            np.float64,
        )

    @classmethod
    def from_array(cls, arr) -> "DatapathSpec":
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        a = np.asarray(arr, np.float64).reshape(-1)
        if a.shape[0] < _SPEC_ARR_LEN - 1:
            raise ValueError(
                f"spec array has {a.shape[0]} slots, expected "
                f"{_SPEC_ARR_LEN - 1} or {_SPEC_ARR_LEN}"
            )
        if a.shape[0] >= _SPEC_ARR_LEN and not np.isnan(a[10]):
            sparsity = _SPARSITY_NAMES.get(float(a[10]))
            if sparsity is None:
                raise ValueError(f"unknown sparsity code {a[10]!r} in spec array")
        else:
            sparsity = None
        return cls(
            version=int(a[0]),
            w_bits=int(a[1]),
            act_bits=int(a[2]),
            act_signed=bool(a[3]),
            tile=None if np.isnan(a[4]) else int(a[4]),
            p_inner=int(a[5]),
            p_outer=int(a[6]),
            static_act=bool(a[7]),
            act_scale=None if np.isnan(a[8]) else float(a[8]),
            act_zp=int(a[9]),
            sparsity=sparsity,
        )


def is_packed_leaf(node) -> bool:
    """Structural test for a packed site (``PackedLinear``)."""
    return getattr(node, "packed", None) is not None


def leaf_datapath(leaf) -> DatapathSpec | None:
    """The spec carried by a packed site: its ``spec`` attribute when set,
    else decoded from the ``spec_arr`` buffer, else None (legacy)."""
    spec = getattr(leaf, "spec", None)
    if spec is not None:
        return spec
    arr = getattr(leaf, "spec_arr", None)
    if arr is not None:
        flat = arr.detach().cpu().numpy().astype(np.float64)
        width = flat.shape[-1] if flat.ndim else flat.shape[0]
        return DatapathSpec.from_array(flat.reshape(-1, width)[0])
    return None


def _packed_sites(model):
    """(module path, module) of every packed site, in module order."""
    return [(name, m) for name, m in model.named_modules() if is_packed_leaf(m)]


def tree_datapath_fingerprint(model) -> str:
    """One stable hash over every packed site's datapath in a model."""
    hashes: list[str] = []
    for _, leaf in _packed_sites(model):
        spec = leaf_datapath(leaf)
        hashes.append(spec.spec_hash() if spec else "legacy")
        hashes.append("+static" if getattr(leaf, "act_scale", None) is not None
                      else "-static")
    return hashlib.sha1("|".join(hashes).encode()).hexdigest()[:16]


def site_key_for_path(path: str, period: int) -> str | None:
    """Plan-site key of a packed module path: ``"layers.2.mixer.wq" ->
    "slot{2 % period}/mixer.wq"`` — the slot-granular key space of the
    reference (repeats of a slot share one key)."""
    m = re.match(r"^layers\.(\d+)\.(.+)$", path)
    if m is None:
        return None
    return f"slot{int(m.group(1)) % period}/" + m.group(2)


def validate_datapath(model, expected) -> int:
    """Check every packed site of ``model`` against ``expected`` — one
    :class:`DatapathSpec`, or a total map of plan-site keys to specs.
    Returns the number of sites checked; raises
    :class:`DatapathMismatchError` on the first disagreement. A site with no
    record is a mismatch too."""
    uniform = isinstance(expected, DatapathSpec)
    period = model.cfg.period
    checked = 0
    seen: set[str] = set()
    for path, leaf in _packed_sites(model):
        spec = leaf_datapath(leaf)
        if spec is None:
            raise DatapathMismatchError(
                f"packed site {path} carries no DatapathSpec (legacy "
                f"artifact) but a datapath was requested; run "
                f"upgrade_packed_params first")
        if uniform:
            spec.require_matches(expected, context=path)
        else:
            key = site_key_for_path(path, period)
            if key is None or key not in expected:
                raise DatapathMismatchError(
                    f"packed site {path} (site {key}) is not named by the "
                    f"mixed-precision site map {sorted(expected)} — refusing "
                    f"to serve an unvalidated site")
            spec.require_matches(expected[key], context=path)
            seen.add(key)
        checked += 1
    if not uniform:
        missing = set(expected) - seen
        if missing:
            raise DatapathMismatchError(
                f"mixed-precision site map names sites with no packed site "
                f"in the model: {sorted(missing)} — refusing")
    return checked


# ---------------------------------------------------------------------------
# Attention accumulator record (quantized KV paging)
# ---------------------------------------------------------------------------
def _signed_acc_limit(p_bits: int) -> int:
    """Symmetric representation limit of a signed P-bit accumulator."""
    return 2 ** (p_bits - 1) - 1


def attn_accumulator_bits(depth: int, hi_a: int, hi_b: int) -> int:
    """Minimum signed accumulator width for a ``depth``-deep dot product
    whose factors are bounded by ``|a| <= hi_a`` and ``|b| <= hi_b`` (the
    Eq. 3 data-type bound: every product at ``hi_a * hi_b``, one sign)."""
    if depth < 1:
        raise ValueError("dot-product depth must be >= 1")
    worst = depth * hi_a * hi_b
    p = 2
    while _signed_acc_limit(p) < worst:
        p += 1
    return p


@dataclass(frozen=True)
class AttnDatapathSpec:
    """The serving datapath of quantized paged attention, as a record.

    It certifies the two reductions attention performs over an int8 KV page
    pool (``repro_torch.kernels.paged_attention``):

    * **QK^T**: a ``head_dim``-deep integer dot of per-head-quantized
      signed ``q_bits`` query codes with signed ``kv_bits`` key codes, held
      in a ``p_qk``-bit register;
    * **PV**: a per-page ``block_size``-deep integer dot of unsigned
      ``prob_bits`` probability codes with signed ``kv_bits`` value codes,
      held in a ``p_pv``-bit register; pages drain into the float
      online-softmax state (the inner/outer split of Eq. 22, with the page
      as the tile).

    Codes are hard-clipped to their alphabets, so both bounds are pure
    data-type bounds that hold for any input and any page scales.
    ``scale_bound`` is calibration numerics and not part of the identity.
    """

    kv_bits: int = 8
    q_bits: int = 8
    prob_bits: int = 8
    head_dim: int = 128  # QK^T reduction depth
    block_size: int = 128  # PV reduction depth (the page = the tile)
    p_qk: int = 22  # = attn_accumulator_bits(128, 127, 127)
    p_pv: int = 23  # = attn_accumulator_bits(128, 255, 127)
    scale_bound: float | None = None

    @property
    def kv_qmax(self) -> int:
        return 2 ** (self.kv_bits - 1) - 1

    @property
    def q_qmax(self) -> int:
        return 2 ** (self.q_bits - 1) - 1

    @property
    def prob_qmax(self) -> int:
        return 2**self.prob_bits - 1

    @classmethod
    def for_cache(cls, head_dim: int, block_size: int, *, kv_bits: int = 8,
                  q_bits: int = 8, prob_bits: int = 8) -> "AttnDatapathSpec":
        """The tight accumulator record for a pool layout (P grows with the
        reduction depth)."""
        kv_hi = 2 ** (kv_bits - 1) - 1
        return cls(
            kv_bits=kv_bits, q_bits=q_bits, prob_bits=prob_bits,
            head_dim=head_dim, block_size=block_size,
            p_qk=attn_accumulator_bits(head_dim, 2 ** (q_bits - 1) - 1, kv_hi),
            p_pv=attn_accumulator_bits(block_size, 2**prob_bits - 1, kv_hi),
        )

    # -- identity -----------------------------------------------------------
    def key(self) -> tuple:
        """Everything the quantized attention kernel depends on
        (``scale_bound`` excluded, as in :meth:`DatapathSpec.key`)."""
        return (self.kv_bits, self.q_bits, self.prob_bits, self.head_dim,
                self.block_size, self.p_qk, self.p_pv)

    def spec_hash(self) -> str:
        return hashlib.sha1(repr(self.key()).encode()).hexdigest()[:12]

    def matches(self, other: "AttnDatapathSpec") -> bool:
        return self.key() == other.key()

    def require_matches(self, other: "AttnDatapathSpec", context: str = "") -> None:
        if not self.matches(other):
            where = f" ({context})" if context else ""
            raise DatapathMismatchError(
                f"attention datapath mismatch{where}: cache built for "
                f"{self.describe()} but {other.describe()} was requested. "
                f"Rebuild the paged cache for the requested datapath — "
                f"serving the accumulator bound of one layout on another "
                f"voids the overflow guarantee."
            )

    def describe(self) -> str:
        return (f"KV{self.kv_bits} Q{self.q_bits} prob{self.prob_bits} "
                f"hd={self.head_dim} bs={self.block_size} "
                f"P_qk={self.p_qk} P_pv={self.p_pv}")

    # -- the certificate ----------------------------------------------------
    def qk_worst_abs(self) -> int:
        """Worst-case |QK^T| partial in integer units."""
        return self.head_dim * self.q_qmax * self.kv_qmax

    def pv_worst_abs(self) -> int:
        """Worst-case |PV| per-page partial in integer units."""
        return self.block_size * self.prob_qmax * self.kv_qmax

    def certify(self) -> bool:
        """True iff both registers hold their worst case."""
        return (self.qk_worst_abs() <= _signed_acc_limit(self.p_qk)
                and self.pv_worst_abs() <= _signed_acc_limit(self.p_pv))


def validate_attn_datapath(spec: AttnDatapathSpec | None,
                           expected: AttnDatapathSpec) -> None:
    """Certify a paged cache's attention datapath against a request: a
    float-KV cache (no record) is a mismatch, and any disagreement raises."""
    if spec is None:
        raise DatapathMismatchError(
            f"cache carries no attention datapath (float KV pages) but "
            f"{expected.describe()} was requested; rebuild with "
            f"kv_dtype='int8'"
        )
    spec.require_matches(expected, context="paged cache")


__all__ = [
    "ARTIFACT_VERSION",
    "AttnDatapathSpec",
    "DatapathMismatchError",
    "DatapathSpec",
    "attn_accumulator_bits",
    "is_packed_leaf",
    "leaf_datapath",
    "site_key_for_path",
    "tree_datapath_fingerprint",
    "validate_attn_datapath",
    "validate_datapath",
]
