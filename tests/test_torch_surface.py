"""The port's module surface, name by name: for every module of
`sonido_sonar_tpu/`, the public names it defines (functions, classes and
assignments at module level, read by `ast`) that the counterpart module
of `sonido_sonar_tpu_torch/` lacks. That list must equal NOT_PORTED
exactly: a name the port gains comes off it, and a name the JAX package
gains must be ported or listed here with its reason. The Pallas wrapper
modules have Hopper counterparts under other names (PALLAS_COUNTERPARTS).
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "sonido_sonar_tpu"
PORT_PKG = ROOT / "sonido_sonar_tpu_torch"

# (module relative to the package) -> public names the port does not define
NOT_PORTED = {
    # the TPU's 1024-aligned flat padding (ROADMAP "Removals")
    "ops/framing.py": {"PAD_QUANTUM", "flatten_padded_rows"},
    # the Pallas wrappers and their TPU availability gates: Hopper kernels
    # under other names (PALLAS_COUNTERPARTS)
    "ops/pallas_stft.py": {"FEAT_LANES", "pallas_stft_available", "stft_magnitude_pallas"},
    "ops/pallas_yin.py": {"pallas_yin_available", "yin_difference_pallas", "yin_pitch_pallas"},
    "ops/pallas_onsets.py": {"thin_onsets_available", "thin_onsets_pallas"},
    "ops/pallas_contrast.py": {"band_select_means_pallas", "pallas_contrast_available"},
    "ops/stats/pallas_dtw.py": {"fill_banded_pallas", "fill_banded_pallas_batch",
                                "fill_banded_pallas_scan_batch", "fill_banded_pallas_scan_pairs",
                                "fill_banded_pallas_scan_pairs_raw", "pallas_dtw_available",
                                "pallas_dtw_scan_available"},
    "ops/stats/pallas_backtrack.py": {"backtrack_banded_pallas", "backtrack_banded_pallas_batch",
                                      "backtrack_banded_pallas_rev", "pallas_backtrack_available"},
    # the process-global Metrics: the port's spans and counters are
    # module-level objects where the work happens (utils/metrics.py)
    "utils/metrics.py": {"get_global_metrics"},
}

# Pallas module -> (Hopper wrapper module, the wrappers it must define)
PALLAS_COUNTERPARTS = {
    "ops/pallas_stft.py": ("ops/hopper_stft.py", {"stft_magnitude_hopper", "stft_magnitude_plain"}),
    "ops/pallas_yin.py": ("ops/hopper_yin.py", {"yin_pitch_hopper", "yin_difference_hopper"}),
    "ops/pallas_onsets.py": ("ops/hopper_onsets.py", {"thin_onsets_hopper"}),
    "ops/pallas_contrast.py": ("ops/hopper_contrast.py", {"band_select_means_hopper"}),
    "ops/stats/pallas_dtw.py": ("ops/stats/hopper_dtw.py", {"fill_banded_hopper"}),
    "ops/stats/pallas_backtrack.py": ("ops/stats/hopper_backtrack.py", {"backtrack_banded_hopper"}),
}


def public_names(path: Path) -> set:
    """Public names a module defines at its top level."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def missing_names() -> dict:
    out = {}
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        twin = PORT_PKG / rel
        lacking = public_names(path) - (public_names(twin) if twin.exists() else set())
        if lacking:
            out[rel] = lacking
    return out


def test_missing_names_are_exactly_not_ported():
    assert missing_names() == NOT_PORTED


@pytest.mark.parametrize("module", sorted(PALLAS_COUNTERPARTS))
def test_pallas_modules_have_hopper_counterparts(module):
    hopper, wrappers = PALLAS_COUNTERPARTS[module]
    assert (JAX_PKG / module).exists() and not (PORT_PKG / module).exists()
    assert wrappers <= public_names(PORT_PKG / hopper)


def test_scanner_reads_definitions_not_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nfrom x import y\nA = 1\nB: int = 2\n_c = 3\n"
                   "def f():\n    g = 1\nclass K:\n    pass\n")
    assert public_names(src) == {"A", "B", "f", "K"}
