#!/usr/bin/env python3
"""Package the official CMU-MOSEI standard folds for the port (port of
``tools/export_mosei_standard_folds.py``): run once on a machine that has
mmsdk installed or a CMU-MultimodalSDK checkout.

    python -m hriemo_torch.tools.export_mosei_standard_folds [--sdk PATH] [--out PATH]

After this, ``python -m hriemo_torch.dataprep.mosei_index`` reproduces the
reference's split membership with no folds file of the user's
(``hriemo_torch/dataprep/standard_folds.py``).
"""

from __future__ import annotations

import argparse

from ..dataprep.standard_folds import (PACKAGED_FOLDS, FoldsUnavailable, export_packaged_folds,
                                       folds_from_mmsdk, folds_from_sdk_checkout)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sdk", type=str, default=None,
                    help="path to a CMU-MultimodalSDK checkout (or directly to "
                         "cmu_mosei_std_folds.py); default: import mmsdk")
    ap.add_argument("--out", type=str, default=str(PACKAGED_FOLDS))
    args = ap.parse_args(argv)

    if args.sdk:
        folds = folds_from_sdk_checkout(args.sdk)
    else:
        try:
            folds = folds_from_mmsdk()
        except ImportError:
            raise SystemExit("mmsdk is not importable: pass --sdk PATH to a "
                             "CMU-MultimodalSDK checkout instead")
        except FoldsUnavailable as e:
            raise SystemExit(str(e))
    return export_packaged_folds(folds, args.out)


if __name__ == "__main__":
    main()
