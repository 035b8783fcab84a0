"""Config / flag system (SURVEY.md F2, §5.6).

Frozen dataclasses with layered overrides, resolved once at init():
defaults -> TOML file -> MP3TPU_* environment variables -> explicit
kwargs/CLI flags. The resolved config is logged once (observability)
and its shape-affecting fields key the jit caches.

Copy of mp3tpu.config, kept in the port so that it imports nothing of
the JAX package; the code is the same.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field, fields


@dataclass(frozen=True)
class DecodeConfig:
    output: str = "int16"          # int16 | float32
    gapless: bool = True
    window_granules: int = 32      # canonical device window (determinism)
    use_native: bool = True        # C++ host fast path (fallback: Python)
    batch_chunk_streams: int = 64  # streams per fixed-shape batch step
    batch_max_mb: int = 512        # host staging cap per chunk; longer
    #                                chunks stream via the scheduler path
    plane_bits: int = 4            # initial packed spectrum plane (4/8/12)
    d2h_segments: int = 4          # decode_batch's window loop in K
    #                                contiguous segments: each segment's
    #                                int16 PCM goes to pinned host memory
    #                                on the copy stream while the next
    #                                segment decodes (transfer.HostCopy);
    #                                the state carries through, so the PCM
    #                                is that of K=1, which is one copy
    #                                after the whole loop.
    d2h_segments_single: int = 2   # the same for decode_symbols_chunked:
    #                                its independent rows in K calls where
    #                                they split evenly; 1 is a single call.


@dataclass(frozen=True)
class PlayerConfig:
    gain_db: float = 0.0
    eq_gains_db: tuple = ()
    ring_capacity_samples: int = 65536
    speed: float = 1.0  # pitch-preserving tempo (dsp/timestretch.py)


@dataclass(frozen=True)
class EncodeConfig:
    bitrate: int = 128
    short_blocks: bool = True
    gapless_tag: bool = True
    joint_stereo: bool = True
    noise_shaping: bool = True
    device_loops: str = "auto"     # auto | on | off: route single-stream
    #                                encodes through the B=1 device batch
    #                                path (encoder.encode_pcm device_loops;
    #                                auto = accelerator present and >=128
    #                                granules)


@dataclass(frozen=True)
class MeshConfig:
    n_devices: int = 0             # 0 = all available
    axis_name: str = "streams"


@dataclass(frozen=True)
class SchedulerConfig:
    n_slots: int = 64
    window_granules: int = 32


@dataclass(frozen=True)
class Config:
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    player: PlayerConfig = field(default_factory=PlayerConfig)
    encode: EncodeConfig = field(default_factory=EncodeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    chaos_corrupt_percent: float = 0.0   # fault injection (§5.3 tests)
    log_config: bool = False


# The process-wide active config: set once by mp3tpu.init() (or
# set_active), read by decode/player/scheduler entry points as the
# default for parameters the caller didn't pass explicitly.
_ACTIVE = Config()


def get_active() -> Config:
    return _ACTIVE


def set_active(cfg: Config) -> Config:
    global _ACTIVE
    _ACTIVE = cfg
    return cfg


def _coerce(val: str, typ):
    if typ is bool:
        return val.lower() in ("1", "true", "yes", "on")
    if typ is tuple:
        return tuple(float(x) for x in val.split(",") if x)
    return typ(val)


def _apply_env(cfg_dict: dict, prefix: str = "MP3TPU_") -> dict:
    """MP3TPU_<SECTION>_<FIELD>=value overrides (e.g. MP3TPU_ENCODE_BITRATE)."""
    for key, val in os.environ.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].lower().split("_", 1)
        if len(parts) != 2:
            continue
        section, name = parts
        if section in cfg_dict and name in cfg_dict[section]:
            cur = cfg_dict[section][name]
            cfg_dict[section][name] = _coerce(val, type(cur))
    return cfg_dict


def _load_toml(path: str) -> dict:
    try:
        import tomllib
        with open(path, "rb") as f:
            return tomllib.load(f)
    except FileNotFoundError:
        return {}


def resolve(toml_path: str | None = None, **overrides) -> Config:
    """Layered resolution: defaults -> TOML -> env -> kwargs."""
    d = {f.name: dataclasses.asdict(getattr(Config(), f.name))
         if dataclasses.is_dataclass(getattr(Config(), f.name)) else
         getattr(Config(), f.name)
         for f in fields(Config)}
    if toml_path:
        file_cfg = _load_toml(toml_path)
        for sec, vals in file_cfg.items():
            if sec in d and isinstance(d[sec], dict):
                d[sec].update(vals)
            elif sec in d:
                d[sec] = vals
    d = _apply_env({k: v for k, v in d.items() if isinstance(v, dict)}) | \
        {k: v for k, v in d.items() if not isinstance(v, dict)}
    for sec, vals in overrides.items():
        if sec in d and isinstance(d[sec], dict) and isinstance(vals, dict):
            d[sec].update(vals)
        else:
            d[sec] = vals
    cfg = Config(
        decode=DecodeConfig(**d["decode"]),
        player=PlayerConfig(**{**d["player"],
                               "eq_gains_db": tuple(d["player"]["eq_gains_db"])}),
        encode=EncodeConfig(**d["encode"]),
        mesh=MeshConfig(**d["mesh"]),
        scheduler=SchedulerConfig(**d["scheduler"]),
        chaos_corrupt_percent=d.get("chaos_corrupt_percent", 0.0),
        log_config=d.get("log_config", False),
    )
    if cfg.log_config:
        print(json.dumps({"mp3tpu_config": dataclasses.asdict(cfg)}))
    return cfg
