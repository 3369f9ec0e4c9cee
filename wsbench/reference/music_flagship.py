"""The plain reference of `configs/music_flagship.json`: MUSIC extraction
and the causal decode of the frozen copy (`frozen/extract.py`,
`frozen/analyze/music.py`, `frozen/reconstruct.py`) with the plain Jacobi
eigendecomposition and candidate selection, computed in float64 (the
configuration states float32: the reference is the more exact side).
Inside `precision.lowered()` it computes as the control: float32, with
the windows and the band windows rounded to bfloat16."""

from __future__ import annotations

import numpy as np
import torch

from wsbench import check
from wsbench.reference import precision
from wsbench.reference.frozen import extract as fx
from wsbench.reference.frozen import reconstruct as fr
from wsbench.reference.frozen.analyze import music as fm
from wsbench.reference.frozen.ops.spectrum import rfft_bins

NUMBER = "windows_off_pct"


def configs(program: dict):
    """(the reference's `ExtractConfig`, `ReconstructConfig`) from the
    configuration file's ``program`` fields."""
    return (fx._build_config(fx.ExtractConfig, program["ExtractConfig"]),
            fx._build_config(fr.ReconstructConfig, program["ReconstructConfig"]))


def _extract(ex, series: torch.Tensor, hop: int) -> torch.Tensor:
    """The frozen `MusicExtractor.forward` on its series-level path, with
    the control's rounding of the windows and the band windows."""
    cfg = ex.cfg
    if cfg.method != fx.Method.MUSIC or not fx._series_fast_path(cfg):
        raise ValueError("the reference covers MUSIC's series-level path only")
    series = ex._series(series, hop)
    series = series - series[..., :1]
    hp_series = ex.main_hp(series)[..., 0, :]
    windows = precision.round_lowered(fx.frame_series(hp_series, cfg.window, hop).contiguous())
    band_w = tuple(precision.round_lowered(w) for w in
                   fm.band_precondition_windows(hp_series, cfg, hop, ex.band_hp))
    seed_spec = rfft_bins(windows)[..., :ex.tables.k_max + 1]
    return fm.music_extract(windows, cfg, band_w, seed_spec, ex.tables)


def outputs(series: np.ndarray, ecfg, rcfg, hop: int, device: torch.device) -> dict:
    """``{"attrs": [nwin, top_k, 15], <decode_causal's keys>: [nwin,
    max_waves]}`` of ``series [L]`` as float64 numpy arrays."""
    dtype = torch.float32 if precision.is_lowered() else torch.float64
    with torch.no_grad():
        ex = fx.MusicExtractor(ecfg, dtype).to(device)
        x = torch.from_numpy(np.asarray(series)).to(device, dtype)
        attrs = _extract(ex, x, hop)
        out = {k: v.double().cpu().numpy() for k, v in fr.decode_causal(attrs, rcfg).items()}
        out["attrs"] = attrs.double().cpu().numpy()
        return out


def answers(program: dict, inputs: dict, device: torch.device) -> dict:
    """What the timed path should have produced for `inputs` (a driver's
    `check_inputs()`: the series and the hop)."""
    ecfg, rcfg = configs(program)
    return outputs(inputs["series"], ecfg, rcfg, inputs["hop"], device)


def compare(got: dict, ref: dict, program: dict) -> tuple[float, str]:
    """The number compared (`check.windows_off`) and what set it."""
    return check.windows_off(got, ref, configs(program)[0].sample_rate_seconds)
