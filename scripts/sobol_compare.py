"""Render the equal-budget prng-vs-sobol comparison figure.

Two renders of the canonical frame at the SAME low sample total
(default 32 spp - low enough that sampler discrepancy dominates), one
with counter-derived PRNG uniforms and one with --sampler sobol's
Owen-scrambled points, saved side by side with a crop row over the sky
gradient (the smooth integrand where QMC stratification shows).  The
visual companion to the sobol oracle and convergence tests (tests/test_qmc.py).

Usage: python scripts/sobol_compare.py [assets_dir]
       SC_SPP overrides the per-image sample count.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ipu_path_trace_tpu.core.records import make_worklist, to_device_batch
from ipu_path_trace_tpu.core.scene import default_scene
from ipu_path_trace_tpu.film.film import Film
from ipu_path_trace_tpu.film.imageio import write_png
from ipu_path_trace_tpu.models.envlight import NifEnv
from ipu_path_trace_tpu.models.nif import load_nif_assets
from ipu_path_trace_tpu.render.params import RenderSettings, StaticConfig
from ipu_path_trace_tpu.render.wavefront import make_base_key, render_step
from ipu_path_trace_tpu.runtime.worklist import coherent_order

W, H = 1104, 1000
SPP = int(os.environ.get("SC_SPP", 32))


def _film(wb):
    film = Film(W, H)
    film.accumulate_soa(wb.u, wb.v, wb.r, wb.g, wb.b, wb.sample_count)
    return film.ldr(1, exposure=0.0, gamma=2.2)


def main() -> None:
    assets = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        REPO, "assets", "nif_w192e16")
    params, _, _ = load_nif_assets(assets, jnp.bfloat16)
    env = NifEnv(params=params)
    scene = default_scene()
    settings = RenderSettings.make(samples_per_step=SPP, seed=7)
    wl = coherent_order(make_worklist(W, H), scene, W, H, 90.0)

    def render(sampler: str):
        cfg = StaticConfig(width=W, height=H, sampler=sampler)
        work = to_device_batch(wl)
        work = render_step(scene, settings, cfg, work, make_base_key(7), env)
        return _film(jax.tree.map(np.asarray, work))

    prng = render("prng")
    sob = render("sobol")

    # Side-by-side full frames + a zoomed crop row over the sky gradient
    # (smooth integrand of the AA dims alone - QMC's best case):
    gap = np.full((H, 8, 3), 255, np.uint8)
    top = np.concatenate([prng, gap, sob], axis=1)
    cy, cx, cs = int(H * 0.18), int(W * 0.30), 220  # crop centre + size
    crops = []
    for img in (prng, sob):
        c = img[cy:cy + cs, cx:cx + cs]
        c = np.repeat(np.repeat(c, 2, axis=0), 2, axis=1)  # 2x zoom
        crops.append(c)
    gap2 = np.full((crops[0].shape[0], 8, 3), 255, np.uint8)
    bottom = np.concatenate([crops[0], gap2, crops[1]], axis=1)
    pad = np.full((bottom.shape[0], top.shape[1] - bottom.shape[1], 3), 20,
                  np.uint8)
    bottom = np.concatenate([bottom, pad], axis=1)
    figure = np.concatenate([top, np.full((8, top.shape[1], 3), 255, np.uint8),
                             bottom], axis=0)
    out = os.path.join(REPO, "docs", "sobol_compare.png")
    write_png(out, figure)
    print(f"wrote {out}: prng (left) vs sobol (right), {SPP} spp each; "
          f"bottom row = 2x crop over the sky gradient")


if __name__ == "__main__":
    main()
