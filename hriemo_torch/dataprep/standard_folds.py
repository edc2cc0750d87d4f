"""Official CMU-MOSEI standard fold resolution (port of
``hriemo/dataprep/standard_folds.py``).

The reference splits by ``mmdatasdk.cmu_mosei.standard_folds``
(reference: scripts/mosei_feature_extraction_seq_level/build_mosei_index_splits.py:31-49):
public video-ID lists shipped inside the CMU-MultimodalSDK. The folds come
from the first available source:

  1. an explicit ``folds_json`` path (``{"train": [...], "valid": [...],
     "test": [...]}``; ``"val"`` is taken for ``"valid"``);
  2. the packaged file ``hriemo_torch/dataprep/data/cmu_mosei_standard_folds.json``,
     written once by ``python -m hriemo_torch.tools.export_mosei_standard_folds``
     on a machine that has mmsdk or a CMU-MultimodalSDK checkout;
  3. an importable ``mmsdk`` package;
  4. a CMU-MultimodalSDK checkout (``sdk_path``), whose fold constants are
     read from ``cmu_mosei_std_folds.py`` with ``ast`` (no exec).

If none gives folds, :func:`load_standard_folds` raises
:class:`FoldsUnavailable`; the hash split of ``mosei_index`` is opt-in only.
"""

from __future__ import annotations

import ast
import json
from pathlib import Path

PACKAGED_FOLDS = Path(__file__).parent / "data" / "cmu_mosei_standard_folds.json"
_FOLD_KEYS = ("train", "valid", "test")


class FoldsUnavailable(RuntimeError):
    pass


def _normalize(folds: dict) -> dict:
    """Accept ``{'val': ...}`` or ``{'valid': ...}``; return canonical keys."""
    out = {}
    for key in _FOLD_KEYS:
        ids = folds.get(key)
        if ids is None and key == "valid":
            ids = folds.get("val")
        if ids is None:
            raise FoldsUnavailable(f"folds source is missing the '{key}' list")
        out[key] = [str(v) for v in ids]
    return out


def folds_from_mmsdk() -> dict:
    from mmsdk import mmdatasdk  # optional dependency

    sf = mmdatasdk.cmu_mosei.standard_folds
    return _normalize({"train": sf.standard_train_fold, "valid": sf.standard_valid_fold,
                       "test": sf.standard_test_fold})


def folds_from_sdk_checkout(sdk_path: str | Path) -> dict:
    """Fold constants of a CMU-MultimodalSDK source tree: the
    ``standard_{train,valid,test}_fold`` list literals of
    ``cmu_mosei_std_folds.py``, read with ``ast``."""
    sdk_path = Path(sdk_path)
    candidates = [sdk_path] if sdk_path.is_file() else sorted(
        sdk_path.rglob("cmu_mosei_std_folds.py"))
    if not candidates:
        raise FoldsUnavailable(f"no cmu_mosei_std_folds.py under {sdk_path}")
    tree = ast.parse(candidates[0].read_text())
    found = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            for key in _FOLD_KEYS:
                if name == f"standard_{key}_fold":
                    found[key] = ast.literal_eval(node.value)
    return _normalize(found)


def load_standard_folds(folds_json: str | Path | None = None,
                        sdk_path: str | Path | None = None) -> dict:
    """Resolve the official folds (the chain of the module docstring)."""
    if folds_json:
        with open(folds_json) as f:
            return _normalize(json.load(f))
    if PACKAGED_FOLDS.exists():
        with open(PACKAGED_FOLDS) as f:
            return _normalize(json.load(f))
    try:
        return folds_from_mmsdk()
    except FoldsUnavailable:
        raise
    except Exception:
        pass
    if sdk_path:
        return folds_from_sdk_checkout(sdk_path)
    raise FoldsUnavailable(
        "official CMU-MOSEI standard folds not found. Provide --folds_json, "
        "or run `python -m hriemo_torch.tools.export_mosei_standard_folds` once "
        "(needs mmsdk or a CMU-MultimodalSDK checkout) to package them at "
        f"{PACKAGED_FOLDS}. The hash split is NOT the official split; "
        "enable it explicitly with --allow_nonstandard_split.")


def export_packaged_folds(folds: dict, out: str | Path = PACKAGED_FOLDS) -> Path:
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    folds = _normalize(folds)
    counts = {k: len(v) for k, v in folds.items()}
    with open(out, "w") as f:
        json.dump(folds, f, indent=0)
    print(f"[folds] wrote {out} ({counts})")
    return out
