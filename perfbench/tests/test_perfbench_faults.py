"""The check decides: a whole run of a cell, past the harness's look for a
card, on the CPU at a small size (`tiny.py`), sound and with the timed path
broken underneath. The sound run reads inside every limit the fault aims
at; each fault, and the control, turn `correct` false through the number
it should.

The faults and the control are `perfbench/faults.py`'s, planted as the
chip's readings plant them: a step that returns its state unchanged (the
tracker, the mapper), half of the batch left out (K1's tiles), an answer
altered where it is produced (the reader's colour).
"""
from __future__ import annotations

import pytest

from perfbench import check, faults, harness
from perfbench.tests import tiny

CELL = "replica_room0.steady"
SEED = 3_000_000_077


def _run(fault, workload=CELL):
    cell, config_file, mix = tiny.load(workload)
    ov, n = tiny.overrides(config_file, 12)
    return faults.run_fault(cell, tiny.at_tiny(config_file),
                            tiny.mix_of(mix, n), fault, SEED, 60.0,
                            device="cpu", overrides=ov)


@pytest.fixture(autouse=True)
def _tmpdir(monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("TMPDIR", str(tmp_path_factory.mktemp("sound")))
        cell, config_file, mix = tiny.load(CELL)
        ov, n = tiny.overrides(config_file, 12)
        res = harness.run_cell(cell, config_file, tiny.mix_of(mix, n), SEED,
                               60.0, False, device="cpu", overrides=ov,
                               log=lambda _: None)
        limits = tiny.at_tiny(config_file)["limits"]
        fails = {k for k, lim in limits.items()
                 if not check.passes(res["numbers"][k], lim)}
        return res, fails
    finally:
        mp.undo()


def test_sound_run_passes(sound):
    res, fails = sound
    assert not fails, res["numbers"]
    assert res["frames"] >= 6


def test_tracker_returning_its_state_fails(sound):
    numbers, fails = _run("tracker_unchanged")
    assert "ate_cm" in fails, numbers


def test_mapper_returning_its_state_fails(sound):
    numbers, fails = _run("mapper_unchanged")
    assert "ate_cm" in fails, numbers


def test_half_the_tiles_left_out_fails(sound):
    numbers, fails = _run("half_tiles")
    assert {"render_mae", "render_depth_rel"} <= set(fails), numbers


def test_altered_frames_fail(sound):
    numbers, fails = _run("brighter_frames")
    assert "frame_color_mae" in fails, numbers


def test_control_fails(sound):
    numbers, fails = _run("control")
    assert {"render_mae", "grad_rel", "frame_color_mae"} <= set(fails), \
        numbers


def test_planted_faults_are_undone():
    from eags_slam_torch.ops import composite_sorted as cs
    from eags_slam_torch.slam import tracker as T

    before = (cs.composite_sorted_fwd, T.Tracker.track)
    for name in ("half_tiles", "tracker_unchanged"):
        with faults.planted(name):
            assert (cs.composite_sorted_fwd, T.Tracker.track) != before
    assert (cs.composite_sorted_fwd, T.Tracker.track) == before
