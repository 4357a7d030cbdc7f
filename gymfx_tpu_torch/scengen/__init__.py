"""Generative scenario suite: seeded synthetic market feeds.

The port of ``gymfx_tpu/scengen/`` (see its package docstring):
regime-switching trend/range dynamics, flash crashes with recovery tails,
gap opens, liquidity droughts, weekend calendar edges and correlated
multi-asset paths, synthesized into ``MarketData`` feeds that the
trainers, the streamer and the LOB venue consume as they do replayed ones.

    params   ScenarioParams + named preset registry + FLAG_* bits
    engine   draw_shocks / paths_from_shocks (K10 on the card) / generate
    oracle   independent NumPy twin of the transform (trust anchor)
    feed     weekend-skipping grid, Frame synthesis, ScenGenDataset
    stress   a preset's overlays on an existing MarketData
"""
from gymfx_tpu_torch.scengen.params import (  # noqa: F401
    FLAG_CRASH,
    FLAG_DROUGHT,
    FLAG_GAP,
    FLAG_HIGHVOL,
    FLAG_TREND,
    ScenarioParams,
    preset_names,
    scenario_params,
)
