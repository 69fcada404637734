"""A tiny configuration and BENCHMARK.json for the CPU tests: the
flagship's structure at small widths."""

from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def flagship() -> dict:
    with open(ROOT / "benchmark" / "configs" / "raggesture_beatx.json") as f:
        return json.load(f)


def tiny_config() -> dict:
    c = copy.deepcopy(flagship())
    c["conditions"] = {"text_frames": 6, "audio_frames": 9}
    c["denoiser"].update(latent_dim=64, time_embed_dim=32, num_layers=2,
                         num_heads=2, ff_size=64, text_latent_dim=24,
                         audio_latent_dim=16, num_speakers=3, max_seq_len=30)
    c["codec"].update(latent_dim=64, num_layers=1, num_heads=1,
                      lowertrans_num_heads=1, ff_size=32, num_frames=30,
                      )
    c["diffusion_test"].update(respace="2,1,1,1,1",
                               num_inference_timesteps=6)
    c["routes"]["sampling"]["graphs"] = False
    return c


def tiny_bench(tmp: Path, traffic: str, cell: str = "tiny.cell",
               limits: dict = None, **mix_params) -> dict:
    """A BENCHMARK.json dict whose one cell runs a copy of the mix
    ``traffic`` on the tiny configuration, both files written under
    ``tmp``.  ``limits`` replace the mix's own: numbers read smaller at the
    tiny size, so a test of the mechanism sets them from the tiny size's
    readings; ``mix_params`` replace others of the mix's parameters."""
    path = tmp / "tiny_config.json"
    path.write_text(json.dumps(tiny_config()))
    mix = json.loads((ROOT / "benchmark" / "traffic"
                      / f"{traffic}.json").read_text())
    if limits is not None:
        mix["limits"] = limits
    mix.update(mix_params)
    (tmp / "tiny_mix.json").write_text(json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    # the metrics of the cells that run this mix, now reported by the cell
    users = {w["name"] for w in bench["workloads"] if w["traffic"] == traffic}
    for kind in ("end_to_end", "per_layer"):
        bench[kind] = [dict(m, workloads=[cell]) for m in bench[kind]
                       if users & set(m.get("workloads", users))]
    bench["configs"] = [{"name": "tiny", "source": "test", "file": str(path),
                         "reduced": [], "why": "test"}]
    # an absolute path in place of a mix's name: the harness joins it to
    # the traffic folder, and pathlib keeps the absolute path
    bench["workloads"] = [{"name": cell, "config": "tiny",
                           "traffic": str(tmp / "tiny_mix"), "chips": 1,
                           "why": "test"}]
    return bench
