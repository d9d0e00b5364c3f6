"""`CommConfig`: one structured config for every inter-machine byte
(port of `repro.comm.config`).

Five planes, each a :class:`PlaneConfig`: ``fw`` (forward activations,
and serving's decode hop), ``bw`` (backward activation gradients),
``zbuf`` (stored message buffers), ``dp`` (data-parallel gradients) and
``kv`` (the serving KV cache).  Wire names are checked against the wire
registry (`repro_torch.comm.wires`) at construction, with a
did-you-mean.  The JSON form (``to_json``/``from_json``, the
``--comm-config`` input) has the same keys and defaults as the JAX
package's, so one config file drives both; the flat CLI flags
(``add_cli_args``/``from_args``/``to_flags``) are the ones ``serve``
and ``train`` take, the ``--dp-wire`` choices and help drawn from the
registry.

The trainers' configs take no scattered comm kwargs: passing one of the
JAX package's removed names (``compression=``, ``dp_grad_bits=``, ...)
raises `reject_legacy_comm`'s migration message, and
`CommConfig.from_legacy` converts such a knob set.

Differences from the JAX package: a plane's ``backend`` is
``auto|reference|cuda``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.comm import wires as W
from repro_torch.comm.codec import Codec
from repro_torch.core import grad_compress as GC
from repro_torch.core.aqsgd import CompressionConfig

MODES = ("fp32", "directq", "aqsgd")
PLANE_FIELDS = ("fw", "bw", "zbuf", "dp", "kv")
BACKEND_CHOICES = ("auto", "reference", "cuda")
DEFAULT_DP_GROUP_D = GC.DEFAULT_GROUP_D
# plane field name -> the registry plane its wire name resolves against
PLANE_OF = {"fw": "fw-activation", "bw": "bw-gradient",
            "zbuf": "z-buffer", "dp": "dp-grad", "kv": "kv-cache"}
_DEFAULT_WIRE = {"fw": "ppermute", "bw": "ppermute", "zbuf": "hbm",
                 "dp": "ring", "kv": "paged"}


@dataclass(frozen=True)
class PlaneConfig:
    """Knobs of one communication plane.

    ``bits=0`` means uncompressed/off.  ``wire`` names the plane's wire
    (empty = the plane's default).  ``error_feedback`` and ``chunks``
    are DP-plane knobs that `CommConfig` normalizes on the others;
    ``group_d`` is the scale-group width (0 = default)."""
    bits: int = 0
    stochastic: bool = True
    backend: str = "auto"
    error_feedback: bool = True
    wire: str = ""
    group_d: int = 0
    chunks: int = 1

    def codec(self) -> Codec:
        """The plane's `Codec` (bits, stochastic and backend bound)."""
        return Codec(bits=self.bits, stochastic=self.stochastic,
                     backend=self.backend)

    def with_(self, **kw) -> "PlaneConfig":
        """`dataclasses.replace` shorthand."""
        return dataclasses.replace(self, **kw)


def _plane(**kw):
    return lambda: PlaneConfig(**kw)


@dataclass(frozen=True)
class CommConfig:
    """The five communication planes plus the activation algorithm
    ``mode`` (``aqsgd`` / ``directq`` / ``fp32``).  Construction
    validates mode, backends, wire names and chunk counts, and fills
    empty wire names with each plane's default."""
    mode: str = "aqsgd"
    fw: PlaneConfig = field(default_factory=_plane(bits=4))
    bw: PlaneConfig = field(default_factory=_plane(bits=8))
    zbuf: PlaneConfig = field(default_factory=_plane(stochastic=False))
    dp: PlaneConfig = field(default_factory=_plane())
    kv: PlaneConfig = field(default_factory=_plane(stochastic=False))
    buffer_dtype: str = "float32"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; one of {MODES}")
        if self.mode != "fp32" and not self.fw.bits:
            raise ValueError("fw.bits=0 (uncompressed forward) requires "
                             "mode='fp32'")
        for fname in PLANE_FIELDS:
            pc = getattr(self, fname)
            if isinstance(pc, dict):
                pc = PlaneConfig(**pc)
            if not pc.wire:
                pc = pc.with_(wire=_DEFAULT_WIRE[fname])
            spec = W.get_wire(pc.wire, plane=PLANE_OF[fname])
            if pc.backend not in BACKEND_CHOICES:
                raise ValueError(f"{fname}.backend={pc.backend!r}; one of "
                                 f"{BACKEND_CHOICES}")
            if fname == "dp" and not pc.group_d:
                pc = pc.with_(group_d=DEFAULT_DP_GROUP_D)
            if not isinstance(pc.chunks, int) \
                    or isinstance(pc.chunks, bool) or pc.chunks < 1:
                raise ValueError(f"{fname}.chunks={pc.chunks!r}: the chunk "
                                 f"count must be a positive int")
            if fname == "dp" and pc.chunks != 1 and not spec.chunkable:
                raise ValueError(f"dp.chunks={pc.chunks} is not supported "
                                 f"by wire {pc.wire!r}; chunkable wires: "
                                 f"{', '.join(_chunkable_dp_wires())}")
            if fname != "dp":
                pc = pc.with_(chunks=1, error_feedback=False)
            if fname == "zbuf":
                pc = pc.with_(stochastic=False)
            object.__setattr__(self, fname, pc)

    # -- derived views ----------------------------------------------------

    @property
    def activation(self) -> CompressionConfig:
        """The activation planes as the `CompressionConfig` that
        `core.aqsgd.apply_boundary` consumes (the codec backend is the
        fw plane's; bw.bits=0 means an uncompressed backward)."""
        return CompressionConfig(
            mode=self.mode, fw_bits=self.fw.bits or 4,
            bw_bits=self.bw.bits or 32, buffer_bits=self.zbuf.bits,
            buffer_dtype=self.buffer_dtype,
            stochastic=self.fw.stochastic, backend=self.fw.backend)

    @property
    def dp_group_d(self) -> int:
        """The DP bucket's scale-group width (normalized at init)."""
        return self.dp.group_d

    @property
    def dp_wire_spec(self) -> W.WireSpec:
        """The registry spec of the configured DP wire."""
        return W.get_wire(self.dp.wire, plane="dp-grad")

    def with_(self, **kw) -> "CommConfig":
        """`dataclasses.replace` shorthand."""
        return dataclasses.replace(self, **kw)

    # -- legacy bridge ----------------------------------------------------

    @classmethod
    def from_legacy(cls, cc: Optional[CompressionConfig] = None, *,
                    buffer_bits: Optional[int] = None,
                    dp_grad_bits: int = 0, dp_wire: str = "",
                    dp_grad_group: int = 0) -> "CommConfig":
        """Build from the JAX package's pre-registry knob set: a
        `CompressionConfig` plus the scattered DP fields the trainer
        configs now refuse (`reject_legacy_comm`)."""
        cc = cc if cc is not None else CompressionConfig()
        zb = cc.buffer_bits if buffer_bits is None else buffer_bits
        return cls(
            mode=cc.mode,
            fw=PlaneConfig(bits=cc.fw_bits, stochastic=cc.stochastic,
                           backend=cc.backend),
            bw=PlaneConfig(bits=0 if cc.bw_bits >= 32 else cc.bw_bits,
                           stochastic=cc.stochastic, backend=cc.backend),
            zbuf=PlaneConfig(bits=zb, stochastic=False, backend=cc.backend),
            dp=PlaneConfig(bits=dp_grad_bits, error_feedback=True,
                           wire=dp_wire, group_d=dp_grad_group,
                           backend=cc.backend, stochastic=cc.stochastic),
            kv=PlaneConfig(stochastic=False, backend=cc.backend),
            buffer_dtype=cc.buffer_dtype)

    # -- JSON -------------------------------------------------------------

    def to_dict(self) -> dict:
        """Plain-dict form (all fields, stable keys)."""
        return {"mode": self.mode, "buffer_dtype": self.buffer_dtype,
                **{f: dataclasses.asdict(getattr(self, f))
                   for f in PLANE_FIELDS}}

    @classmethod
    def from_dict(cls, d: dict) -> "CommConfig":
        """Inverse of `to_dict`; unknown keys (top-level or per-plane)
        raise, so typos cannot silently no-op."""
        d = dict(d)
        kw = {top: d.pop(top) for top in ("mode", "buffer_dtype")
              if top in d}
        pfields = {f.name for f in dataclasses.fields(PlaneConfig)}
        for fname in PLANE_FIELDS:
            if fname not in d:
                continue
            sub = dict(d.pop(fname))
            unknown = set(sub) - pfields
            if unknown:
                raise ValueError(f"unknown {fname} plane key(s) "
                                 f"{sorted(unknown)}; known: "
                                 f"{sorted(pfields)}")
            kw[fname] = dataclasses.replace(getattr(CommConfig(), fname),
                                            **sub)
        if d:
            raise ValueError(f"unknown CommConfig key(s) {sorted(d)}; "
                             f"known: mode, buffer_dtype, "
                             f"{', '.join(PLANE_FIELDS)}")
        return cls(**kw)

    def to_json(self, **kw) -> str:
        """JSON form (the ``--comm-config`` input format)."""
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "CommConfig":
        """Parse `to_json` output (or any subset of its keys)."""
        return cls.from_dict(json.loads(s))


    # -- flat CLI flags ---------------------------------------------------

    def to_flags(self) -> list:
        """The flat-flag form of this config (inverse of `from_args`).
        Raises where the flat flags cannot say it (backends or
        stochastic rounding that differ across planes, non-default
        fw/bw/zbuf/kv wires, ...): use ``--comm-config`` JSON for
        those."""
        planes = [self.fw, self.bw, self.dp]
        if len({p.backend for p in planes + [self.zbuf, self.kv]}) > 1:
            raise ValueError("per-plane backends differ; flat flags "
                             "cannot express this — use --comm-config")
        if len({p.stochastic for p in planes}) > 1:
            raise ValueError("per-plane stochastic differs; use "
                             "--comm-config")
        if self.kv.stochastic:
            raise ValueError("kv.stochastic is not flag-expressible "
                             "(flat --kv-bits builds a deterministic "
                             "cache codec); use --comm-config")
        for fname in ("fw", "bw", "zbuf", "kv"):
            if getattr(self, fname).wire != _DEFAULT_WIRE[fname]:
                raise ValueError(f"non-default {fname} wire; use "
                                 "--comm-config")
            if getattr(self, fname).group_d:
                raise ValueError(f"{fname}.group_d is not "
                                 "flag-expressible; use --comm-config")
        if self.buffer_dtype != "float32":
            raise ValueError("non-default buffer_dtype; use "
                             "--comm-config")
        flags = ["--mode", self.mode,
                 "--fw-bits", str(self.fw.bits),
                 "--bw-bits", str(self.bw.bits),
                 "--buffer-bits", str(self.zbuf.bits),
                 "--dp-grad-bits", str(self.dp.bits),
                 "--dp-wire", self.dp.wire,
                 "--dp-grad-group", str(self.dp_group_d),
                 "--dp-chunks", str(self.dp.chunks),
                 "--kv-bits", str(self.kv.bits),
                 "--backend", self.fw.backend]
        if not self.fw.stochastic:
            flags.append("--no-stochastic")
        if not self.dp.error_feedback:
            flags.append("--no-error-feedback")
        return flags


def _chunkable_dp_wires() -> list:
    return [s.name for s in W.list_wires("dp-grad") if s.chunkable]


def reject_legacy_comm(cls_name: str, legacy: dict) -> None:
    """Refuse the JAX package's removed scattered comm kwargs
    (``compression=``, ``dp_grad_bits=``, ``dp_wire=``, ...) on a
    trainer config, with its migration message.  ``legacy`` maps kwarg
    name -> passed value (None = not passed)."""
    passed = sorted(k for k, v in legacy.items() if v is not None)
    if passed:
        raise TypeError(
            f"{cls_name}({', '.join(k + '=...' for k in passed)}) was "
            f"removed: the scattered comm kwargs spent their one "
            f"deprecation release and are now errors.  Pass "
            f"comm=CommConfig(...) (repro_torch.comm) instead — "
            f"CommConfig.from_legacy(CompressionConfig(...), "
            f"dp_grad_bits=..., dp_wire=...) converts the old knob "
            f"set verbatim")


def add_cli_args(ap) -> None:
    """Install the flat comm flags plus ``--comm-config`` on an argparse
    parser (the flags of the JAX package's ``serve`` and ``train``).
    The ``--dp-wire`` choices and their help come from the registry's
    ``dp-grad`` plane."""
    dp_names = W.wire_names("dp-grad")
    dp_help = "; ".join(f"{s.name}: {s.summary}"
                        for s in W.list_wires("dp-grad"))
    ap.add_argument("--mode", default="aqsgd", choices=list(MODES),
                    help="activation-boundary algorithm (fw plane)")
    ap.add_argument("--fw-bits", type=int, default=4,
                    help="forward activation code width")
    ap.add_argument("--bw-bits", type=int, default=8,
                    help="backward activation-gradient code width "
                         "(0 = uncompressed)")
    ap.add_argument("--buffer-bits", type=int, default=0,
                    help="z-bit stored message buffers (0 = raw dtype)")
    ap.add_argument("--dp-grad-bits", type=int, default=0,
                    help="DP gradient code width (0 = off)")
    ap.add_argument("--dp-wire", default="ring", choices=dp_names,
                    help="DP gradient collective — " + dp_help)
    ap.add_argument("--dp-grad-group", type=int, default=DEFAULT_DP_GROUP_D,
                    help="DP gradient-bucket scale-group width")
    ap.add_argument("--dp-chunks", type=int, default=1,
                    help="DP ring chunk count (chunkable wires: "
                         + ", ".join(_chunkable_dp_wires()) + ")")
    ap.add_argument("--kv-bits", type=int, default=0,
                    help="serving KV-cache code width (0 = raw cache "
                         "dtype; quantize-on-append, "
                         "dequantize-on-attend)")
    ap.add_argument("--backend", default="auto",
                    choices=list(BACKEND_CHOICES),
                    help="boundary codec backend for every plane")
    ap.add_argument("--no-stochastic", action="store_true",
                    help="deterministic rounding on every plane")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="drop the DP carried-error state")
    ap.add_argument("--comm-config", default="",
                    help="full CommConfig as JSON — a literal string or a "
                         "path to a .json file; overrides the flat comm "
                         "flags above")


def from_args(args) -> CommConfig:
    """Build a `CommConfig` from parsed `add_cli_args` flags;
    ``--comm-config`` wins wholesale when given."""
    if args.comm_config:
        src = args.comm_config
        if os.path.exists(src):
            with open(src) as f:
                src = f.read()
        return CommConfig.from_json(src)
    common = dict(stochastic=not args.no_stochastic, backend=args.backend)
    return CommConfig(
        mode=args.mode,
        fw=PlaneConfig(bits=args.fw_bits, **common),
        bw=PlaneConfig(bits=args.bw_bits, **common),
        zbuf=PlaneConfig(bits=args.buffer_bits, stochastic=False,
                         backend=args.backend),
        dp=PlaneConfig(bits=args.dp_grad_bits, wire=args.dp_wire,
                       group_d=args.dp_grad_group, chunks=args.dp_chunks,
                       error_feedback=not args.no_error_feedback, **common),
        kv=PlaneConfig(bits=args.kv_bits, stochastic=False,
                       backend=args.backend))
