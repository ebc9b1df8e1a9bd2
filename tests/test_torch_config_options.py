"""The map and track path's options as config branches, each a tiny
GaussianSLAM run on the CPU through the kernels' twins (the runs of
tests/test_torch_config_branches.py, in a file of their own so that
neither file runs long under `--dist loadfile`)."""
import pytest

from test_torch_config_branches import _run_branch


@pytest.mark.parametrize("case", [
    "kernel_bf16", "kernel_quadform", "tile_subset", "init_halfres_frac",
    "debug_per_iter"])
def test_ported_config_branches_run(tmp_path, monkeypatch, case):
    """The options that used to raise now run: the K1-K4 variants
    (`mapping.kernel_bf16`, `kernel_quadform`), the mapper's tile subset
    (`mapping.tile_subset`: 8 of the 24 tiles each iteration), the
    half-resolution submap init (`mapping.init_halfres_frac`: frame 0's
    first 4 of 8 iterations) and the tracker's per-iteration records
    (`tracking.debug_per_iter`: one "track_iters" record a tracked frame in
    log.jsonl)."""
    _run_branch(tmp_path, monkeypatch, case)
