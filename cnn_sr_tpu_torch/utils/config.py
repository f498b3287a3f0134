"""JSON network/config reader with the reference's schema and validation rules.

The port's own copy of ``cnn_sr_tpu/utils/config.py`` (json and
dataclasses only), so that the port runs where JAX is not installed. The
two must parse every config to equal fields; ``tests/test_torch_model.py``
holds them together.

Reproduces the behavior of the reference config system
(``src/Config.{hpp,cpp}``, ``example_config.json``):

* fields: ``n1, n2, f1, f2, f3`` (architecture), ``momentum``,
  ``weight_decay_parameter``, ``learning_rates[3]``, optional
  ``parameters_file``, and three ``parameters_distribution_{1,2,3}``
  objects ``{mean_w, mean_b, std_deviation_w, std_deviation_b}``
  (Config.cpp:103-147);
* distribution values are absolute-valued on read, mirroring
  ``fix_params_distribution`` (Config.cpp:87-92);
* validation: f odd and > 0, n > 0, every learning rate > 0,
  weight_decay >= 0, sd_w > 0, sd_b >= 0 (Config.cpp:46-74);
* ``total_padding() = f1 + f2 + f3 - 3`` (Config.cpp:44).

Extensions over the reference (layer-list-generic architectures, needed
for the deeper waifu2x-style RGB variants): a config may instead provide

* ``channels``: number of image channels the net consumes/produces
  (default 1 = luma-only, like the reference; 3 = full RGB);
* ``layers``: ``[{"n": <filter count>, "f": <spatial size>}, ...]`` —
  an arbitrary-depth stack listed EXPLICITLY including the final layer,
  whose ``n`` must equal ``channels`` (validated);
* ``learning_rates`` must then have one entry per layer, and either a
  single ``parameters_distribution`` (applied to all layers) or
  per-layer ``parameters_distribution_<i>`` objects may be given.

An inference-only architecture config names its ``arch`` instead: ``{"arch":
"rrdbnet", "channels": 3, "scale": 4, "num_feat": 64, "num_grow_ch": 32,
"num_block": 23}`` is Real-ESRGAN x4plus (basicsr's ``RRDBNet``), parsed into
an ``RRDBNetConfig``: its layers are derived from those keys
(``rrdbnet_layers``), its convolutions are SAME (``total_padding()`` 0) and it
takes no training keys. The JAX package reads no such config.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


class ConfigError(ValueError):
    """Raised for structurally invalid / unparseable configs."""


class ConfigValidationError(ConfigError):
    """Raised when config values violate the validation rules."""


def _require(cond: bool, msg: str) -> None:
    # mirrors cnn_sr::utils::require (pch.cpp:23-27)
    if not cond:
        raise ConfigValidationError(msg)


@dataclass
class ParametersDistribution:
    """Normal-distribution hyperparameters for random weight/bias init.

    Mirrors ``ParametersDistribution`` (Config.hpp) with the same
    absolute-value normalization applied on read (Config.cpp:87-92).
    """

    mean_w: float = 0.0
    mean_b: float = 0.0
    sd_w: float = 0.0
    sd_b: float = 0.0

    def fixed(self) -> "ParametersDistribution":
        return ParametersDistribution(
            mean_w=abs(self.mean_w),
            mean_b=abs(self.mean_b),
            sd_w=abs(self.sd_w),
            sd_b=abs(self.sd_b),
        )


@dataclass(frozen=True)
class LayerSpec:
    """Static shape of one conv layer (valid padding, stride 1).

    ``weights`` layout contract is ``[f, f, k(prev), n(curr)]`` with the
    current-filter index fastest (layer_uber_kernel.cl:3-12) — which is
    exactly JAX's HWIO filter layout.
    """

    f: int        # spatial size (f x f kernel)
    n_in: int     # previous layer filter count (k)
    n_out: int    # this layer's filter count (n)
    relu: bool    # ReLU activation (the last layer is linear: SKIP_RELU)

    @property
    def weight_size(self) -> int:
        # LayerData.cpp:62-67
        return self.f * self.f * self.n_in * self.n_out

    @property
    def bias_size(self) -> int:
        return self.n_out

    def out_size(self, in_h: int, in_w: int) -> tuple:
        # valid conv shrinkage: out = in - f + 1 (LayerData.cpp:56-60)
        return (in_h - self.f + 1, in_w - self.f + 1)


@dataclass
class Config:
    """Parsed + validated network/training configuration."""

    # the architecture: "srcnn", a stack of VALID convolutions (every config
    # the reference reads); ``RRDBNetConfig`` sets "rrdbnet". A class
    # attribute, not a field, so that the JAX package's Config compares equal
    arch = "srcnn"

    @property
    def same(self) -> bool:
        """Whether the model's convolutions are SAME-padded (an inference-only
        arch, ``RRDBNetConfig``): nothing shrinks, and the paths whose
        guarantees need VALID convolutions refuse it."""
        return self.arch != "srcnn"

    # per-layer filter counts; the final entry is the output channel count
    filter_counts: List[int] = field(default_factory=list)   # [n1, n2, ..., channels]
    spatial_sizes: List[int] = field(default_factory=list)   # [f1, f2, ..., fL]
    momentum: float = 0.0
    weight_decay: float = 0.0
    learning_rates: List[float] = field(default_factory=list)
    parameters_file: Optional[str] = None
    distributions: List[ParametersDistribution] = field(default_factory=list)
    channels: int = 1  # 1 = luma-only (reference behavior); 3 = full RGB
    # Extension: train against mean-relative targets. The reference
    # mean-subtracts the INPUT luma only (Main_cl.cpp:141) while targets
    # stay absolute — so the net must guess each image's mean, an
    # irreducible-error floor of Var(per-image mean) on data whose crop
    # means vary (fine for natural photos, ruinous for synthetic sets).
    # With zero_mean_target=true the net predicts (luma − input_mean)
    # and inference adds the input mean back.
    zero_mean_target: bool = False
    # Extension: whether training keeps the reference's last-layer ReLU'
    # gradient quirk (last_layer_delta.cl:42-47 applies ReLU' although
    # layer 3 is linear). Defaults to True (parity) — except under
    # zero_mean_target, where the gate freezes every pixel whose signed
    # target is negative, so it defaults off there (still overridable
    # explicitly). None = resolve that default in __post_init__, so the
    # coupling holds for direct Config(...) construction too, not just
    # parse_config.
    last_layer_relu_gate: Optional[bool] = None
    # Binary-compat quirk: subtract E[luma²] instead of the mean from
    # model inputs, replicating the shipped reference binary's cl_event*→
    # bool conversion bug in DataPipeline::subtract_mean
    # (DataPipeline.cpp:276 vs DataPipeline.hpp:171 — see
    # ops/color.py:subtract_mean and docs/REFERENCE_PARITY.md). Off by
    # default: the intended semantics. Turn on to reproduce the binary
    # bit-for-bit or to run weights the binary trained. Luma models only.
    subtract_squared_mean: bool = False

    def __post_init__(self):
        if self.last_layer_relu_gate is None:
            self.last_layer_relu_gate = not self.zero_mean_target

    # --- classic 3-layer accessors (reference parity) ---
    @property
    def n1(self) -> int:
        return self.filter_counts[0]

    @property
    def n2(self) -> int:
        return self.filter_counts[1]

    @property
    def f1(self) -> int:
        return self.spatial_sizes[0]

    @property
    def f2(self) -> int:
        return self.spatial_sizes[1]

    @property
    def f3(self) -> int:
        return self.spatial_sizes[2]

    @property
    def num_layers(self) -> int:
        return len(self.spatial_sizes)

    def total_padding(self) -> int:
        """Sum of valid-conv shrinkage over all layers (Config.cpp:44)."""
        return sum(f - 1 for f in self.spatial_sizes)

    def layer_specs(self) -> List[LayerSpec]:
        """The canonical layer list: ReLU on all layers but the last
        (ConfigBasedDataPipeline.cpp:54-75 compiles layer 3 with SKIP_RELU)."""
        specs = []
        n_in = self.channels
        for i, (f, n_out) in enumerate(zip(self.spatial_sizes, self.filter_counts)):
            is_last = i == self.num_layers - 1
            specs.append(LayerSpec(f=f, n_in=n_in, n_out=n_out, relu=not is_last))
            n_in = n_out
        return specs

    def validate(self) -> None:
        """Same rules as Config::validate (Config.cpp:46-74), generalized
        to N layers."""
        for f in self.spatial_sizes:
            _require(f > 0, "f should be >0")
            _require(f % 2 == 1, "f should be odd")
        for n in self.filter_counts[:-1]:
            _require(n > 0, "n should be >0")
        _require(self.filter_counts[-1] == self.channels,
                 "last layer must produce `channels` outputs")
        _require(self.weight_decay >= 0, "weight_decay should be >=0")
        _require(len(self.learning_rates) == self.num_layers,
                 "need one learning rate per layer")
        _require(all(lr > 0 for lr in self.learning_rates),
                 "All learning rates should be >0")
        _require(len(self.distributions) == self.num_layers,
                 "need one parameters distribution per layer")
        for pd in self.distributions:
            _require(pd.sd_w > 0, "std dev. for weights should be > 0")
            _require(pd.sd_b >= 0, "std dev. for bias should be >= 0")
        for v in (self.momentum, self.weight_decay, *self.learning_rates):
            _require(not math.isnan(v), "config value is NaN")
        _require(not (self.subtract_squared_mean and self.channels != 1),
                 "subtract_squared_mean replicates the reference binary's "
                 "luma-pipeline quirk; it requires channels == 1")

    def __str__(self) -> str:
        # pretty print a la Config::operator<< (Config.cpp:150-175)
        lines = ["Config {"]
        for i, (f, n) in enumerate(zip(self.spatial_sizes, self.filter_counts)):
            lines.append(f"  layer {i + 1}: {n} filters, {f}x{f} kernel")
        lines.append(f"  momentum: {self.momentum}")
        lines.append(f"  weight_decay: {self.weight_decay}")
        lines.append(f"  learning rates: {self.learning_rates}")
        lines.append(f"  channels: {self.channels}")
        if self.parameters_file:
            lines.append(f"  parameters file: '{self.parameters_file}'")
        lines.append("}")
        return "\n".join(lines)


def rrdbnet_layers(channels: int, num_feat: int, num_grow_ch: int, num_block: int) -> list:
    """basicsr's ``RRDBNet`` (scale 4) as ``[(f, k, n), ...]`` in its
    ``state_dict`` order: conv_first, then ``body.{b}.rdb{1,2,3}.conv{1..5}``
    (inputs num_feat + i num_grow_ch, outputs num_grow_ch, conv5 back to
    num_feat), conv_body, conv_up1, conv_up2, conv_hr, conv_last; every
    convolution 3x3 SAME."""
    rdb = [(3, num_feat + i * num_grow_ch, num_grow_ch) for i in range(4)]
    rdb.append((3, num_feat + 4 * num_grow_ch, num_feat))
    trunk = rdb * 3 * num_block
    head = [(3, num_feat, num_feat)] * 4 + [(3, num_feat, channels)]
    return [(3, channels, num_feat)] + trunk + head


@dataclass
class RRDBNetConfig(Config):
    """An inference-only RRDBNet (ESRGAN, Real-ESRGAN x4plus): ``channels``
    in and out, ``scale`` 4, its widths and blocks. ``filter_counts`` and
    ``spatial_sizes`` list its 3 + 15 ``num_block`` + 5 convolutions
    (``rrdbnet_layers``); every one is SAME, so nothing shrinks."""

    arch = "rrdbnet"
    scale: int = 4
    num_feat: int = 64
    num_grow_ch: int = 32
    num_block: int = 23

    def layers(self) -> list:
        return rrdbnet_layers(self.channels, self.num_feat, self.num_grow_ch, self.num_block)

    def total_padding(self) -> int:
        return 0

    def layer_specs(self) -> List[LayerSpec]:
        """Each convolution with its true input width (a dense block's read
        its concatenated inputs); ``relu`` marks the LeakyReLU ones."""
        layers = self.layers()
        last_rdb = 1 + 15 * self.num_block
        specs = []
        for i, (f, k, n) in enumerate(layers):
            rdb_conv = 1 <= i < last_rdb and (i - 1) % 5 < 4
            specs.append(LayerSpec(f=f, n_in=k, n_out=n,
                                   relu=rdb_conv or last_rdb + 1 <= i < len(layers) - 1))
        return specs

    def validate(self) -> None:
        _require(self.scale == 4, "rrdbnet: scale must be 4 (two nearest x2 upsamples)")
        _require(self.channels > 0, "rrdbnet: channels should be >0")
        _require(min(self.num_feat, self.num_grow_ch, self.num_block) > 0,
                 "rrdbnet: num_feat, num_grow_ch and num_block should be >0")
        _require(self.num_feat % 8 == 0 and self.num_grow_ch % 8 == 0,
                 "rrdbnet: num_feat and num_grow_ch must be multiples of 8")


def _parse_rrdbnet(raw: dict) -> RRDBNetConfig:
    try:
        keys = {k: int(raw[k]) for k in ("scale", "num_feat", "num_grow_ch", "num_block")}
    except KeyError as e:
        raise ConfigError(f"rrdbnet: missing required config field: {e}") from e
    channels = int(raw.get("channels", 3))
    layers = rrdbnet_layers(channels, keys["num_feat"], keys["num_grow_ch"], keys["num_block"])
    cfg = RRDBNetConfig(filter_counts=[n for _, _, n in layers],
                        spatial_sizes=[f for f, _, _ in layers], channels=channels, **keys)
    cfg.validate()
    return cfg


def _read_distribution(obj: dict) -> ParametersDistribution:
    return ParametersDistribution(
        mean_w=float(obj.get("mean_w", 0.0)),
        mean_b=float(obj.get("mean_b", 0.0)),
        sd_w=float(obj.get("std_deviation_w", 0.0)),
        sd_b=float(obj.get("std_deviation_b", 0.0)),
    ).fixed()


def parse_config(raw: dict, base_dir: Optional[str] = None) -> Config:
    """Build + validate a Config from a parsed JSON object.

    ``base_dir``: directory the config file lives in. A relative
    ``parameters_file`` stays cwd-relative (reference behavior) when it
    resolves from the cwd; when it does NOT but does resolve relative to
    the config's own directory, the config-relative path is used — so
    shipped configs like ``configs/srcnn_9-5-5_pretrained.json`` work
    from any working directory instead of silently random-initializing.
    """
    import os

    if not isinstance(raw, dict):
        raise ConfigError("config root must be a JSON object")
    arch = raw.get("arch", "srcnn")
    if arch == "rrdbnet":
        return _parse_rrdbnet(raw)
    if arch != "srcnn":
        raise ConfigError(f"unknown arch {arch!r} (srcnn or rrdbnet)")

    channels = int(raw.get("channels", 1))
    params_file = raw.get("parameters_file") or None
    if (params_file and base_dir and not os.path.isabs(params_file)
            and not os.path.isfile(params_file)):
        alt = os.path.join(base_dir, params_file)
        if os.path.isfile(alt):
            params_file = alt

    if "layers" in raw:
        # generic layer-list schema
        layers = raw["layers"]
        if not isinstance(layers, list) or not layers:
            raise ConfigError("'layers' must be a non-empty list")
        spatial = [int(l["f"]) for l in layers]
        filters = [int(l["n"]) for l in layers]
        num_layers = len(layers)
        lrs = [float(x) for x in raw.get("learning_rates", [])]
        dists: List[ParametersDistribution] = []
        if "parameters_distribution" in raw:
            d = _read_distribution(raw["parameters_distribution"])
            dists = [d] * num_layers
        else:
            for i in range(num_layers):
                key = f"parameters_distribution_{i + 1}"
                if key not in raw:
                    raise ConfigError(f"missing '{key}'")
                dists.append(_read_distribution(raw[key]))
    else:
        # classic 3-layer schema (Config.cpp:103-147)
        try:
            n1 = int(raw["n1"])
            n2 = int(raw["n2"])
            f1 = int(raw["f1"])
            f2 = int(raw["f2"])
            f3 = int(raw["f3"])
        except KeyError as e:
            raise ConfigError(f"missing required config field: {e}") from e
        spatial = [f1, f2, f3]
        filters = [n1, n2, channels]
        lrs = [float(x) for x in raw.get("learning_rates", [])]
        dists = []
        for i in (1, 2, 3):
            key = f"parameters_distribution_{i}"
            if key not in raw:
                raise ConfigError(f"missing '{key}'")
            dists.append(_read_distribution(raw[key]))

    cfg = Config(
        filter_counts=filters,
        spatial_sizes=spatial,
        momentum=float(raw.get("momentum", 0.0)),
        weight_decay=float(raw.get("weight_decay_parameter", 0.0)),
        learning_rates=lrs,
        parameters_file=params_file,
        distributions=dists,
        channels=channels,
        zero_mean_target=bool(raw.get("zero_mean_target", False)),
        last_layer_relu_gate=(
            bool(raw["last_layer_relu_gate"])
            if "last_layer_relu_gate" in raw else None
        ),
        subtract_squared_mean=bool(raw.get("subtract_squared_mean", False)),
    )
    cfg.validate()
    return cfg


def read_config(path: str) -> Config:
    """Read + parse + validate a config file (ConfigReader::read,
    Config.cpp:103-147). Raises FileNotFoundError / ConfigError /
    ConfigValidationError like the reference's error classes."""
    import os

    with open(path, "r") as fh:
        text = fh.read()
    try:
        raw = json.loads(text)
    except json.JSONDecodeError as e:
        raise ConfigError(f"could not parse config '{path}': {e}") from e
    return parse_config(raw, base_dir=os.path.dirname(path))
