"""Write each asset directory's converted.npz from its converted.hdf5.

The loader (models/nif.load_nif_assets) prefers converted.npz, so a
render needs no HDF5 library; HDF5 stays the interchange format that
models/convert.py and the reference write.  Run where h5py is installed:

    python scripts/export_npz.py assets/*/

Each .npz holds bit-identical arrays (tests/test_nif_reference.py).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ipu_path_trace_tpu.models.nif import NifWeights  # noqa: E402


def main(dirs: list[str]) -> None:
    for d in dirs:
        h5 = os.path.join(d, "converted.hdf5")
        if not os.path.exists(h5):
            continue
        out = os.path.join(d, "converted.npz")
        NifWeights.load_h5(h5).save_npz(out)
        print(f"wrote {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
