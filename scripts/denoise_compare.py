"""Regenerate docs/denoise_compare.png: raw vs --denoise side by side.

Renders the caustic scene under the procedural-sky texture env at 16
spp twice through the real CLI (once raw, once --denoise) and composes
the two PNGs.  CPU-friendly (small frame); run with
  JAX_PLATFORMS=cpu python scripts/denoise_compare.py
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ipu_path_trace_tpu.film.imageio import write_png  # noqa: E402


def render(outfile: str, extra: list[str]) -> None:
    cmd = [sys.executable, "-m", "ipu_path_trace_tpu.runtime.cli",
           "-o", outfile, "-w", "256", "-H", "256",
           "-s", "16", "--samples-per-step", "16",
           "--scene", os.path.join(REPO, "assets", "scenes",
                                   "glass_caustic.json"),
           "--assets", "texture:" + os.path.join(REPO, "assets",
                                                 "procedural_sky.exr"),
           "--seed", "5"] + extra
    subprocess.run(cmd, check=True, capture_output=True)


def read_png_rgb(path: str) -> np.ndarray:
    try:
        import matplotlib.image as mpimg

        return (mpimg.imread(path)[:, :, :3] * 255).astype(np.uint8)
    except ImportError:  # EXR twin is always written alongside
        from ipu_path_trace_tpu.film.film import tone_map
        from ipu_path_trace_tpu.film.imageio import read_exr

        return tone_map(read_exr(path[:-4] + ".exr"), 1, 0.0, 2.2)


def main() -> None:
    td = tempfile.mkdtemp()
    raw, dn = os.path.join(td, "raw.png"), os.path.join(td, "dn.png")
    render(raw, [])
    render(dn, ["--denoise"])
    a, b = read_png_rgb(raw), read_png_rgb(dn)
    sep = np.full((a.shape[0], 4, 3), 255, np.uint8)
    out = os.path.join(REPO, "docs", "denoise_compare.png")
    write_png(out, np.concatenate([a, sep, b], axis=1))
    print(f"wrote {out} (left: raw 16 spp, right: --denoise)")


if __name__ == "__main__":
    main()
