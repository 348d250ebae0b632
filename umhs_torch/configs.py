"""Config tree, dotted-flag CLI parsing and the config.yml round trip (port of
umhs_tpu/configs.py).

    FullConfig
    ├── trainer: TrainerConfig  (machine.seed, steps_per_save, vis, ...)
    ├── pipeline.num_classes, pipeline.check_nan
    ├── pipeline.model: ModelConfig
    └── pipeline.datamanager: DataManagerConfig
        └── dataparser: DataParserConfig

Flags are spelled as tyro spells them: dashes and underscores are the same
(`--pipeline.model.far-plane` == `--pipeline.model.far_plane`), `--flag=value`
works, booleans are True/False words, tuple fields take `8,16` or `"8 16"`,
Optional fields take `None`, and an unknown flag raises with the valid names.
The reference's flags without a counterpart (`--machine.num-devices`,
`--viewer.websocket-port`, ...) are accepted and recorded as inert.

config.yml is the JAX package's file: the same `__dataclass__` / `__path__`
tree, written and read here without PyYAML by a small emitter and reader for
exactly the subset that tree uses (nested block mappings, block lists of
scalars, and str, int, float, bool and null scalars), which PyYAML reads to
the same values. A file written by either package loads in the other. The
fields that exist only in umhs_tpu's dataclasses are listed in `JAX_ONLY`
with what the port does with each: none is dropped without a word.
"""

from __future__ import annotations

import dataclasses
import math
import re
import typing
from pathlib import Path
from typing import Any, Dict, List, Tuple

from .data.datamanager import DataManagerConfig
from .data.dataparser import DataParserConfig
from .engine.trainer import OptimizerConfig, TrainerConfig
from .models.model import ModelConfig
from .ops.encodings import HashEncodingConfig


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    num_classes: int = 5
    check_nan: bool = False
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    datamanager: DataManagerConfig = dataclasses.field(default_factory=DataManagerConfig)


@dataclasses.dataclass(frozen=True)
class FullConfig:
    method_name: str = "umhsnerf"
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)


def umhs_method_defaults() -> FullConfig:
    """The reference's umhsnerf method config (umhs_config.py:35-67)."""
    return FullConfig(
        trainer=TrainerConfig(
            max_num_iterations=30000,
            steps_per_save=2000,
            steps_per_eval_batch=500,
            mixed_precision=True,
            save_only_latest_checkpoint=False,
            optimizer=OptimizerConfig(lr=2e-2, eps=1e-15, lr_final=1e-5, max_steps=30000),
        ),
        pipeline=PipelineConfig(
            model=ModelConfig(eval_num_rays_per_chunk=4096),
            datamanager=DataManagerConfig(
                train_num_rays_per_batch=9216 * 4,
                eval_num_rays_per_batch=4096,
            ),
        ),
    )


# ---------------------------------------------------------------------------
# the fields of umhs_tpu's dataclasses that the port's do not have
# ---------------------------------------------------------------------------

_COMPILE = "an XLA compile or dispatch option on the TPU; the math is the same"

# (dataclass, field) -> (what the port does, the JAX default, why).
# "inert": accepted, recorded and printed, otherwise ignored (the value does
# not change what is computed here).
JAX_ONLY: Dict[Tuple[str, str], Tuple[str, Any, str]] = {
    ("TrainerConfig", "fuse_occ_update"): ("inert", True, _COMPILE),
    ("TrainerConfig", "fast_compile_effort"): ("inert", -1.0, _COMPILE),
    ("TrainerConfig", "background_full_compile"): ("inert", True, _COMPILE),
    ("TrainerConfig", "full_compile_defer_chunks"): ("inert", 3, _COMPILE),
    ("ModelConfig", "hash_split_dense_gather"): (
        "inert", False, "the TPU's gather layout of the dense hash levels; same values"),
    ("HashEncodingConfig", "split_dense_gather"): (
        "inert", False, "the TPU's gather layout of the dense hash levels; same values"),
}


# ---------------------------------------------------------------------------
# dotted flag parsing
# ---------------------------------------------------------------------------

# reference flag -> config path aliases (tyro spellings kept working)
_ALIASES = {
    "data": "pipeline.datamanager.dataparser.data",
    "experiment_name": "trainer.experiment_name",
    "output_dir": "trainer.output_dir",
    "vis": "trainer.vis",
    "machine.seed": "trainer.seed",
    "max_num_iterations": "trainer.max_num_iterations",
    "steps_per_save": "trainer.steps_per_save",
    "steps_per_eval_batch": "trainer.steps_per_eval_batch",
    "steps_per_eval_image": "trainer.steps_per_eval_image",
    "steps_per_log": "trainer.steps_per_log",
    "save_only_latest_checkpoint": "trainer.save_only_latest_checkpoint",
    "mixed_precision": "trainer.mixed_precision",
    "gradient_accumulation_steps": "trainer.gradient_accumulation_steps",
    "log_gradients": "trainer.log_gradients",
    "load_dir": "trainer.load_dir",
    "load_step": "trainer.load_step",
    "optimizers.fields.optimizer.lr": "trainer.optimizer.lr",
    "optimizers.fields.optimizer.eps": "trainer.optimizer.eps",
    "optimizers.fields.scheduler.lr_final": "trainer.optimizer.lr_final",
    "optimizers.fields.scheduler.max_steps": "trainer.optimizer.max_steps",
    "pipeline.datamanager.dataparser.num_classes": "pipeline.num_classes",
}

# the reference's flags that have no counterpart: accepted, recorded, inert
_IGNORED = {
    "machine.num_devices",
    "machine.num_machines",
    "viewer.websocket_port",
    "viewer.num_rays_per_chunk",
    "pipeline.model.implementation",
    "pipeline.datamanager.images_on_gpu",
    "pipeline.datamanager.images_on_device",
    "logging.local_writer.enable",
}


def _canon(flag: str) -> str:
    return flag.lstrip("-").replace("-", "_")


def _parse_value(raw: str, typ: Any):
    """A flag's text as a value of the field's type."""
    origin, args = typing.get_origin(typ), typing.get_args(typ)
    if origin is not None and type(None) in args:  # Optional[...]
        if raw.lower() in ("none", "null"):
            return None
        return _parse_value(raw, [a for a in args if a is not type(None)][0])
    if typ is bool:
        if raw.lower() in ("true", "1", "yes"):
            return True
        if raw.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"expected bool, got {raw!r}")
    if origin in (tuple, list):
        inner = [a for a in args if a is not Ellipsis]
        vals = [_parse_value(p, inner[0] if inner else str)
                for p in raw.replace(",", " ").split()]
        return tuple(vals) if origin is tuple else vals
    if typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    if typ is Path:
        return Path(raw)
    return raw


def _set_path(cfg, dotted: str, raw: str, inert: Dict[str, str], path: str):
    """A copy of cfg with cfg.<dotted> set to the parsed `raw`; a JAX-only
    inert field is recorded in `inert` instead."""
    head, _, rest = dotted.partition(".")
    fields = {f.name for f in dataclasses.fields(cfg)}
    if head not in fields:
        if rest or (type(cfg).__name__, head) not in JAX_ONLY:
            raise KeyError(f"unknown config field '{head}' on {type(cfg).__name__}; "
                           f"valid: {sorted(fields)}")
        inert[path] = raw
        return cfg
    if rest:
        sub = _set_path(getattr(cfg, head), rest, raw, inert, path)
        return dataclasses.replace(cfg, **{head: sub})
    typ = typing.get_type_hints(type(cfg))[head]
    return dataclasses.replace(cfg, **{head: _parse_value(raw, typ)})


def apply_cli_overrides(config: FullConfig, argv: List[str]) -> Tuple[FullConfig, Dict[str, str]]:
    """Apply --dotted.flag value pairs; returns (config, inert flags): the
    reference's flags without a counterpart and the JAX-only fields of
    JAX_ONLY, by canonical name, with their text."""
    ignored: Dict[str, str] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"expected --flag, got {arg!r}")
        if "=" in arg:
            flag, raw = arg.split("=", 1)
            i += 1
        else:
            flag = arg
            if i + 1 >= len(argv):
                raise ValueError(f"flag {flag} missing a value")
            raw = argv[i + 1]
            i += 2
        key = _canon(flag)
        key = _ALIASES.get(key, key)
        if key in _IGNORED:
            ignored[key] = raw
            continue
        config = _set_path(config, key, raw, ignored, key)
    return config, ignored


# ---------------------------------------------------------------------------
# config.yml: the dataclass tree as plain values
# ---------------------------------------------------------------------------

_DATACLASSES = {cls.__name__: cls for cls in (
    FullConfig, PipelineConfig, TrainerConfig, OptimizerConfig, ModelConfig,
    DataManagerConfig, DataParserConfig, HashEncodingConfig)}


def _to_plain(obj):
    if dataclasses.is_dataclass(obj):
        out = {"__dataclass__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            value = getattr(obj, f.name)
            if isinstance(obj, ModelConfig) and f.name == "impl" and value == f.default:
                continue  # port-only; left out at its default so the file is umhs_tpu's
            out[f.name] = _to_plain(value)
        return out
    if isinstance(obj, Path):
        return {"__path__": str(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(x) for x in obj]
    return obj


def _from_plain(obj, inert: Dict[str, Any], path: str = ""):
    if isinstance(obj, dict):
        if "__path__" in obj:
            return Path(obj["__path__"])
        if "__dataclass__" in obj:
            name = obj["__dataclass__"]
            if name not in _DATACLASSES:
                raise KeyError(f"unknown config dataclass {name!r} ({path or 'top'})")
            cls = _DATACLASSES[name]
            known = {f.name for f in dataclasses.fields(cls)}
            kwargs = {}
            for k, v in obj.items():
                if k == "__dataclass__":
                    continue
                sub = f"{path}.{k}" if path else k
                if k in known:
                    kwargs[k] = _from_plain(v, inert, sub)
                elif (name, k) in JAX_ONLY:
                    inert[sub] = v
                else:
                    raise KeyError(f"unknown config field '{k}' on {name} ({sub})")
            for f in dataclasses.fields(cls):  # tuple fields come back as lists
                if isinstance(kwargs.get(f.name), list):
                    kwargs[f.name] = tuple(kwargs[f.name])
            return cls(**kwargs)
        return {k: _from_plain(v, inert, f"{path}.{k}") for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_plain(x, inert, path) for x in obj]
    return obj


def save_config(config: FullConfig, path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(dump_yaml(_to_plain(config)))


def read_config(path: Path) -> Tuple[FullConfig, Dict[str, Any]]:
    """(config, the JAX-only inert fields found, by dotted path)."""
    inert: Dict[str, Any] = {}
    config = _from_plain(load_yaml(Path(path).read_text()), inert)
    return config, inert


def load_config(path: Path) -> FullConfig:
    config, inert = read_config(path)
    if inert:
        print(f"[umhs_torch.configs] {path}: inert fields of umhs_tpu's config: {inert}")
    return config


# ---------------------------------------------------------------------------
# YAML for the subset above, read by PyYAML (yaml.safe_load) to the same values
# ---------------------------------------------------------------------------

# PyYAML's implicit resolvers (YAML 1.1): a plain scalar that one of these
# matches is read as that type, so a str like that is written quoted
_BOOL = {"yes", "Yes", "YES", "no", "No", "NO", "true", "True", "TRUE", "false", "False",
         "FALSE", "on", "On", "ON", "off", "Off", "OFF"}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_PLAIN_STR = re.compile(r"^[A-Za-z0-9_./][A-Za-z0-9_./+\-]*$")
_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _emit_float(x: float) -> str:
    """PyYAML's representer: .nan, .inf, -.inf, else repr with a '.0' put
    before an exponent that has no dot (1e-15 -> 1.0e-15: YAML 1.1 reads a
    float only with a dot)."""
    if x != x:
        return ".nan"
    if x in (math.inf, -math.inf):
        return ".inf" if x > 0 else "-.inf"
    text = repr(x).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _emit_str(s: str) -> str:
    if (_PLAIN_STR.match(s) and s not in _BOOL and s not in _NULL and not _INT.match(s)
            and not _FLOAT.match(s) and not _TIMESTAMP.match(s)):
        return s
    if all(" " <= c <= "~" for c in s):
        return "'" + s.replace("'", "''") + "'"
    out = []
    for c in s:
        if c in '"\\':
            out.append("\\" + c)
        elif " " <= c <= "~":
            out.append(c)
        else:
            out.append(f"\\U{ord(c):08x}" if ord(c) > 0xFFFF else f"\\u{ord(c):04x}")
    return '"' + "".join(out) + '"'


def _emit_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _emit_float(v)
    if isinstance(v, str):
        return _emit_str(v)
    raise TypeError(f"config.yml holds no {type(v).__name__} ({v!r})")


def _emit(obj: dict, indent: int, lines: List[str]) -> None:
    pad = " " * indent
    for k, v in obj.items():
        if not isinstance(k, str) or not _KEY.match(k) or k in _BOOL or k in _NULL:
            raise ValueError(f"config.yml key {k!r} is not an identifier that reads as a str")
        if isinstance(v, dict) and v:
            lines.append(f"{pad}{k}:")
            _emit(v, indent + 2, lines)
        elif isinstance(v, list) and v:
            lines.append(f"{pad}{k}:")
            for item in v:  # PyYAML's indentless block list
                if isinstance(item, (dict, list)):
                    raise ValueError(f"config.yml lists hold scalars only ({k})")
                lines.append(f"{pad}- {_emit_scalar(item)}")
        elif isinstance(v, dict):
            lines.append(f"{pad}{k}: {{}}")
        elif isinstance(v, list):
            lines.append(f"{pad}{k}: []")
        else:
            lines.append(f"{pad}{k}: {_emit_scalar(v)}")


def dump_yaml(obj: dict) -> str:
    """Block YAML of a mapping of mappings, lists of scalars and scalars,
    in the layout of yaml.safe_dump(obj, sort_keys=False)."""
    lines: List[str] = []
    _emit(obj, 0, lines)
    return "\n".join(lines) + "\n"


def _read_int(s: str) -> int:
    """PyYAML's construct_yaml_int."""
    value = s.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        total, base = 0, 1
        for digit in reversed([int(p) for p in value.split(":")]):
            total += digit * base
            base *= 60
        return sign * total
    return sign * int(value)


def _read_float(s: str) -> float:
    """PyYAML's construct_yaml_float."""
    value = s.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        total, base = 0.0, 1
        for digit in reversed([float(p) for p in value.split(":")]):
            total += digit * base
            base *= 60
        return sign * total
    return sign * float(value)


_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _read_scalar(text: str):
    if text.startswith("'"):
        if len(text) < 2 or not text.endswith("'") or "'" in text[1:-1].replace("''", ""):
            raise ValueError(f"config.yml: unsupported single-quoted scalar {text!r}")
        return text[1:-1].replace("''", "'")
    if text.startswith('"'):
        out, i = [], 1
        while i < len(text) - 1:
            c = text[i]
            if c == "\\":
                e = text[i + 1]
                if e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    out.append(chr(int(text[i + 2:i + 2 + n], 16)))
                    i += 2 + n
                    continue
                out.append(_ESCAPES[e])
                i += 2
                continue
            if c == '"':
                break
            out.append(c)
            i += 1
        if i != len(text) - 1 or not text.endswith('"'):
            raise ValueError(f"config.yml: unsupported double-quoted scalar {text!r}")
        return "".join(out)
    if text == "{}":
        return {}
    if text == "[]":
        return []
    if text in _NULL:
        return None
    if text in _BOOL:
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        return _read_int(text)
    if _FLOAT.match(text):
        return _read_float(text)
    if _TIMESTAMP.match(text) or text[0] in "[{&*!|>%@`#,?:" or " #" in text:
        raise ValueError(f"config.yml: unsupported scalar {text!r}")
    return text


def load_yaml(text: str):
    """The mapping of a YAML document in dump_yaml's subset (which is also
    what yaml.safe_dump writes for the config tree); anything else raises."""
    lines = []
    for n, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.lstrip().startswith("#") or line.strip() == "---":
            continue
        stripped = line.lstrip(" ")
        lines.append((len(line) - len(stripped), stripped.rstrip(), n))
    pos = 0

    def mapping(indent: int) -> dict:
        nonlocal pos
        out = {}
        while pos < len(lines) and lines[pos][0] == indent and not lines[pos][1].startswith("- "):
            _, body, n = lines[pos]
            key, sep, rest = body.partition(":")
            if (not sep or not _KEY.match(key) or key in _BOOL or key in _NULL
                    or (rest and not rest.startswith(" "))):
                raise ValueError(f"config.yml line {n}: expected 'key: value', got {body!r}")
            pos += 1
            rest = rest.strip()
            if rest:
                out[key] = _read_scalar(rest)
            elif pos < len(lines) and lines[pos][1].startswith("- ") and lines[pos][0] in (
                    indent, indent + 2):
                out[key] = sequence(lines[pos][0])
            elif pos < len(lines) and lines[pos][0] > indent:
                out[key] = mapping(lines[pos][0])
            else:
                out[key] = None
        if pos < len(lines) and lines[pos][0] > indent:
            raise ValueError(f"config.yml line {lines[pos][2]}: unexpected indentation")
        return out

    def sequence(indent: int) -> list:
        nonlocal pos
        out = []
        while pos < len(lines) and lines[pos][0] == indent and lines[pos][1].startswith("- "):
            item = lines[pos][1][2:].strip()
            if item.startswith("- ") or re.match(r"^[A-Za-z_]\w*:( |$)", item):
                raise ValueError(f"config.yml line {lines[pos][2]}: lists hold scalars only")
            out.append(_read_scalar(item))
            pos += 1
        return out

    if not lines:
        return None
    result = mapping(lines[0][0])
    if pos != len(lines):
        raise ValueError(f"config.yml line {lines[pos][2]}: unexpected content")
    return result
