"""Dataset-of-tapes registry and the curriculum tape sampler.

The port of ``gymfx_tpu/data/tapes.py``: ``TapeSpec``,
``parse_tape_specs`` (both grammars: ``"file:PATH[@W],scengen:PRESET[@W]"``
strings and JSON lists of dicts whose extra keys overlay the base config
for that tape), ``overlay_config``, ``dataset_for_spec``,
``_TapePickerBase`` and ``CurriculumSampler``.  Many CSV files become one
logical dataset: every tape is built through the same
``build_market_data`` with the environment's kwargs, and all tapes must
have the same bar count.

``feed=curriculum`` draws a weighted, seed-deterministic tape per
superstep boundary with numpy's PCG64 (``np.random.default_rng``), the
JAX package's draws bit for bit.  With ``data_compress`` on, tapes 1..
are held compressed on the device (data/compress.py) and each pick
decodes its f32 view through K6, bitwise the uncompressed tape.

A ``scengen:`` tape is generated on the environment's device
(scengen/feed.ScenGenDataset: K10 on the card).  ``PortfolioCurriculumSampler``
draws whole portfolio books the same way.  Not ported here: the
``curriculum_pick`` ledger row (the telemetry port); the draws are kept
in ``picks``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

TAPE_KINDS = ("file", "scengen")


class TapeSpec(NamedTuple):
    kind: str                       # "file" | "scengen"
    source: str                     # CSV path | preset name
    weight: float
    label: str
    overrides: Tuple[Tuple[str, Any], ...] = ()


def _spec_from_entry(entry: Any, idx: int) -> TapeSpec:
    if isinstance(entry, str):
        body = entry.strip()
        weight = 1.0
        if "@" in body:
            body, _, w = body.rpartition("@")
            try:
                weight = float(w)
            except ValueError:
                raise ValueError(
                    f"tapes entry {entry!r}: weight after '@' must be a "
                    f"number, got {w!r}"
                ) from None
        kind, sep, source = body.partition(":")
        if not sep or kind not in TAPE_KINDS or not source:
            raise ValueError(
                f"tapes entry {entry!r} must look like "
                "'file:PATH[@WEIGHT]' or 'scengen:PRESET[@WEIGHT]'"
            )
        overrides: Dict[str, Any] = {}
    elif isinstance(entry, dict):
        entry = dict(entry)
        kinds = [k for k in TAPE_KINDS if k in entry]
        if len(kinds) != 1:
            raise ValueError(
                f"tapes entry {entry!r} must have exactly one of "
                f"{TAPE_KINDS} as a key"
            )
        kind = kinds[0]
        source = str(entry.pop(kind))
        weight = float(entry.pop("weight", 1.0))
        overrides = entry  # remaining keys overlay the base config
    else:
        raise ValueError(
            f"tapes entry #{idx} must be a 'kind:source' string or a "
            f"dict, got {type(entry).__name__}"
        )
    if not (np.isfinite(weight) and weight > 0):
        raise ValueError(
            f"tapes entry {source!r}: weight must be a finite positive "
            f"number, got {weight!r}"
        )
    label = f"{kind}:{source}"
    return TapeSpec(kind, source, float(weight), label,
                    tuple(sorted(overrides.items())))


def parse_tape_specs(config: Dict[str, Any]) -> Tuple[TapeSpec, ...]:
    """The ``tapes`` config key -> validated specs (honor-or-reject)."""
    raw = config.get("tapes")
    if raw is None or raw == "" or raw == []:
        raise ValueError(
            "feed=curriculum requires the 'tapes' config key: a "
            "'file:PATH[@W],scengen:PRESET[@W]' string or a JSON list "
            "of {file|scengen, weight, ...} dicts"
        )
    if isinstance(raw, str):
        s = raw.strip()
        if s.startswith("["):
            try:
                raw = json.loads(s)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"tapes looks like JSON but does not parse: {e}"
                ) from e
        else:
            raw = [part for part in s.split(",") if part.strip()]
    if not isinstance(raw, (list, tuple)) or not raw:
        raise ValueError(
            f"tapes must be a non-empty list of tape entries, got {raw!r}"
        )
    specs = tuple(_spec_from_entry(e, i) for i, e in enumerate(raw))
    labels = [s.label for s in specs]
    dupes = {x for x in labels if labels.count(x) > 1}
    if dupes:
        raise ValueError(
            f"tapes lists the same tape more than once: {sorted(dupes)}; "
            "merge the weights instead"
        )
    return specs


def overlay_config(config: Dict[str, Any], spec: TapeSpec) -> Dict[str, Any]:
    """Base config overlaid for ONE tape: the spec's source + overrides,
    with the curriculum keys stripped so nested dataset builds cannot
    recurse."""
    overlay = dict(config)
    overlay.pop("tapes", None)
    overlay.update(dict(spec.overrides))
    if spec.kind == "file":
        overlay["feed"] = "replay"
        overlay["input_data_file"] = spec.source
    else:
        overlay["feed"] = "scengen"
        overlay["scengen_preset"] = spec.source
    return overlay


def dataset_for_spec(config: Dict[str, Any], spec: TapeSpec, device=None):
    """Resolve one tape spec into a MarketDataset (replay or scengen; a
    scengen tape is generated on ``device``)."""
    overlay = overlay_config(config, spec)
    if spec.kind == "file":
        from gymfx_tpu_torch.data.feed import load_market_dataset

        return load_market_dataset(overlay)
    from gymfx_tpu_torch.scengen.feed import ScenGenDataset

    return ScenGenDataset(overlay, device=device)


class _TapePickerBase:
    """Weighted, seed-deterministic draws over the registry, with
    ``np.random.default_rng(curriculum_seed)`` (PCG64): the JAX
    package's draws for the same seed."""

    def _init_picker(self, config: Dict[str, Any], specs: Sequence[TapeSpec]) -> None:
        self.specs = tuple(specs)
        w = np.asarray([s.weight for s in self.specs], np.float64)
        self.weights = w / w.sum()
        seed = config.get("curriculum_seed")
        if seed is None:
            seed = config.get("seed", 0)
        self.seed = int(seed or 0)
        self.rng = np.random.default_rng(self.seed)
        self.picks: List[Tuple[int, int]] = []  # (it_start, tape_index)

    @property
    def num_tapes(self) -> int:
        return len(self.specs)

    def _tape_data(self, i: int):
        raise NotImplementedError

    def pick(self, it_start: int):
        """Draw the tape for the superstep starting at ``it_start`` ->
        ``(index, label, device data)``; the draw is a ``curriculum_pick``
        row of the active run ledger, when there is one."""
        from gymfx_tpu_torch.telemetry.ledger import get_active_ledger

        i = int(self.rng.choice(len(self.specs), p=self.weights))
        self.picks.append((int(it_start), i))
        ledger = get_active_ledger()
        if ledger is not None:
            ledger.record("curriculum_pick", it_start=int(it_start), tape=self.specs[i].label,
                          tape_index=i, seed=self.seed)
        return i, self.specs[i].label, self._tape_data(i)


class CurriculumSampler(_TapePickerBase):
    """Seed-deterministic weighted tape sampler over the registry.

    Tape 0 is the Environment's own dataset (its MarketData is used as
    it is, so a one-tape curriculum is plain replay); tapes 1.. are built
    on the host with the same ``build_market_data`` kwargs and either
    held on the device in f32 (``data_compress=off``) or encoded whole
    (``encode_tape``) and held compressed on the device, their f32 view
    decoded per pick (``on`` / ``interpret``: K6 on the card).
    """

    def __init__(self, config: Dict[str, Any], specs: Sequence[TapeSpec], *, base_data,
                 md_kwargs: Dict[str, Any], device, compress: str = "off",
                 tick_size: float = 1e-5):
        from gymfx_tpu_torch.data import compress as C
        from gymfx_tpu_torch.data.feed import market_data_nbytes, market_data_to_device

        self._init_picker(config, specs)
        self.compress = C.validate_compress_mode(compress)
        n0 = int(base_data.close.shape[0])
        self._decoded_nbytes = market_data_nbytes(base_data)
        self._compressed_nbytes: Optional[int] = 0 if self.compress != "off" else None
        self._device: Dict[int, Any] = {0: base_data}
        self._tapes: Dict[int, Any] = {}
        self._decoders: Dict[int, Any] = {}
        for i, spec in enumerate(self.specs[1:], start=1):
            host = dataset_for_spec(config, spec, device).build_market_data(device=None,
                                                                            **md_kwargs)
            n = int(host.close.shape[0])
            if n != n0:
                raise ValueError(
                    "curriculum tapes must all have the same bar count "
                    "(one compiled train step serves every tape): tape "
                    f"{i} {spec.label!r} has {n} bars, tape 0 "
                    f"{self.specs[0].label!r} has {n0}; trim the files "
                    "or set scengen_bars to match"
                )
            if self.compress == "off":
                self._device[i] = market_data_to_device(host, device)
                continue
            tape = C.encode_tape(
                host, window_size=int(md_kwargs["window_size"]), tick_size=float(tick_size),
                what=f" (curriculum tape {spec.label})",
            )
            self._tapes[i] = C.device_tape(tape, device)
            self._compressed_nbytes += tape.nbytes
            # one decoder per tape: each tape picks its own codecs (the JAX
            # sampler decodes every tape with the first tape's columns)
            self._decoders[i] = C.make_shard_decoder(self._tapes[i], self.compress, device)

    def nbytes_report(self) -> Dict[str, Any]:
        """Decoded vs compressed library accounting (tape 0 is always
        resident f32: it is the Environment's own dataset)."""
        n = self.num_tapes
        return {
            "decoded": self._decoded_nbytes * n,
            "compressed": self._compressed_nbytes,
            "ratio": None if not self._compressed_nbytes else (
                self._decoded_nbytes * (n - 1) / self._compressed_nbytes
            ),
        }

    def tape(self, i: int):
        """Tape ``i``'s compressed form (None for tape 0 and for f32 tapes)."""
        return self._tapes.get(i)

    def _tape_data(self, i: int):
        if i in self._device:
            return self._device[i]
        from gymfx_tpu_torch.data import compress as C

        return self._decoders[i](C.shard_arrays(self._tapes[i], 0))


class PortfolioCurriculumSampler(_TapePickerBase):
    """Curriculum over whole portfolio books.  Each non-base tape is built
    by a throwaway ``PortfolioEnvironment`` on the overlaid config (one
    level deep: the overlay strips the curriculum keys), so every tape
    carries its own aligned multi-pair data and conversion factors.  A
    ``file:`` tape is a single CSV, not a book: portfolio tapes are
    scengen presets or dict entries with a ``portfolio_files`` override.
    ``data_compress`` does not apply to portfolio books."""

    def __init__(self, config: Dict[str, Any], specs: Sequence[TapeSpec], *, base_env):
        from gymfx_tpu_torch.core.portfolio import PortfolioEnvironment

        self._init_picker(config, specs)
        n0 = int(base_env.cfg.n_bars)
        self._device: Dict[int, Any] = {0: base_env.data}
        for i, spec in enumerate(self.specs[1:], start=1):
            if spec.kind == "file" and "portfolio_files" not in dict(spec.overrides):
                raise ValueError(
                    f"portfolio curriculum tape {spec.label!r}: a 'file:' "
                    "tape is a single CSV, not a multi-pair book; use the "
                    "dict form with a 'portfolio_files' override, or a "
                    "scengen preset"
                )
            env_i = PortfolioEnvironment(overlay_config(config, spec), device=base_env.device)
            if int(env_i.cfg.n_bars) != n0:
                raise ValueError(
                    "curriculum tapes must all have the same bar count "
                    "(one compiled train step serves every tape): tape "
                    f"{i} {spec.label!r} has {env_i.cfg.n_bars} aligned "
                    f"bars, tape 0 {self.specs[0].label!r} has {n0}; "
                    "trim the books or set scengen_bars to match"
                )
            self._device[i] = env_i.data

    def _tape_data(self, i: int):
        return self._device[i]
