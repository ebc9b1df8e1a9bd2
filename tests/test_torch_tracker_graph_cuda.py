"""The tracker's refine loop replayed as CUDA graphs (`RefineGraph`)
against the eager loop, on the card: `track_frame` with a graph runner
returns the eager loop's relative pose, exposure, stats and iteration
count bit for bit on the 1/4 tile subset with exposure off and on, on the
subset + polish path with the pose-contraction backward (K4), and with the
iteration budget doubled, while every iteration launches its K1 and K2 / K4
through the modules' entry points on the loop's stream, K2 / K4 taking the
`out` of the K1 call before it (what a launch counter wrapping those entry
points sees); one runner over two frames whose frozen layouts differ in
size recaptures and still matches; `Tracker.track` counts its captures,
replays and iterations; and over 5 tracked frames at each benchmark cell's
shape (TUM RGB-D 540x380 with 50,000 gaussians, Replica 1200x680 with
150,000; tile 32) the graphed frames' allocated peak is at most the eager
frames' plus 16 MiB and after them within 1 MiB of it, their reserved peak
and the graph pool's reserved bytes printed beside it.

These tests need a CUDA card and skip without one; like
`test_torch_kernels_cuda.py` this file imports no JAX:

    python -m pytest --noconftest -m cuda -s tests/test_torch_tracker_graph_cuda.py

(`-s` prints the memory readings.)
"""
import numpy as np
import pytest
import torch

from eags_slam_torch.core.camera import Camera
from eags_slam_torch.core.gaussians import GaussianParams
from eags_slam_torch.core.se3 import se3_exp
from eags_slam_torch.core.sh import sh_to_rgb
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.ops import rasterizer as rz
from eags_slam_torch.ops.rasterizer import RasterConfig, render
from eags_slam_torch.slam import tracker as T
from eags_slam_torch.utils import tracing

pytestmark = pytest.mark.cuda

TUM = Camera(fx=517.3, fy=516.5, cx=268.6, cy=190.7, width=540, height=380)
REPLICA = Camera(fx=600.0, fy=600.0, cx=599.5, cy=339.5, width=1200,
                 height=680)
RCFG = RasterConfig(tile=32, dup_side=3, seg_cap=1024, bands=3)
# The TUM cell's tracker (perfbench/configs/tum_fr1_desk.json) at fewer
# iterations, the early stop kept out of the way unless a case asks.
TUM_TRACK = dict(w_color_loss=0.6, alpha_thre=0.98, early_stop_thre=5e-5,
                 early_stop_cnt=200, plateau_patience=5, plateau_factor=0.95)
MIB = 1 << 20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")
    tracing.disable()
    tracing.drain()
    yield torch.device("cuda")
    tracing.disable()
    tracing.drain()


def _map(n, device, seed):
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g)

    xyz = torch.stack([u(-1.6, 1.6, n), u(-1.1, 1.1, n), u(1.5, 4.0, n)], -1)
    q = torch.randn(n, 4, generator=g)
    q = q / q.norm(dim=-1, keepdim=True)
    rgb = u(0.1, 0.9, n, 3)
    p = {"xyz": xyz, "f_dc": (rgb - 0.5) / 0.28209479177387814,
         "f_rest": torch.zeros(n, 15, 3),
         "log_scales": torch.log(u(0.01, 0.05, n, 3)), "quats": q,
         "opacity_logits": u(1.0, 5.0, n, 1)}
    return (GaussianParams(**{k: v.to(device) for k, v in p.items()}),
            torch.ones(n, dtype=torch.bool, device=device))


def _frame(params, alive, tau, device, cam=TUM):
    """The map rendered at w2c = exp(tau): (gt colour, gt depth)."""
    w2c = se3_exp(torch.tensor(tau)).float().to(device)
    with torch.no_grad():
        out = render(params.xyz, params.quats, params.log_scales,
                     params.opacity_logits, sh_to_rgb(params.f_dc), w2c,
                     cam, RCFG, alive=alive)
    depth = torch.where(out.alpha > 0.5,
                        out.depth / torch.clamp(out.alpha, min=1e-6), 0.0)
    return out.color.contiguous(), depth.contiguous()


def _candidates(tau, device):
    near = np.asarray(tau, np.float32) + np.float32(0.004)
    return torch.stack([se3_exp(torch.tensor(near)),
                        torch.eye(4)]).float().to(device)


def _track(params, alive, rels, gt, tcfg, graph, med=np.inf, cam=TUM):
    return T.track_frame(params, alive, rels, torch.eye(4, device=rels.device),
                         gt[0], gt[1], med, med,
                         torch.zeros(2, device=rels.device), cam, RCFG, tcfg,
                         graph=graph)


class _Entries:
    """Wraps K1's, K2's and K4's entry points in their modules, as a launch
    counter does: each call's kernel, stream, and for K2 / K4 whether its
    `out` is the one the K1 call before it returned."""

    def __init__(self, monkeypatch):
        self.calls = []
        self._out = None
        fwd, bwd, pose = (cs.composite_sorted_fwd, cs.composite_sorted_bwd,
                          cs.pose_grad_sorted)

        def k1(*args, **kw):
            out, cols = fwd(*args, **kw)
            self._out = out
            self.calls.append(("K1", self._stream(), True))
            return out, cols

        def k2(attrs, tile_ids, out, *args, **kw):
            self.calls.append(("K2", self._stream(), out is self._out))
            return bwd(attrs, tile_ids, out, *args, **kw)

        def k4(attrs, jac, tile_ids, out, *args, **kw):
            self.calls.append(("K4", self._stream(), out is self._out))
            return pose(attrs, jac, tile_ids, out, *args, **kw)

        for mod in (cs, rz):
            monkeypatch.setattr(mod, "composite_sorted_fwd", k1)
            monkeypatch.setattr(mod, "pose_grad_sorted", k4)
        monkeypatch.setattr(cs, "composite_sorted_bwd", k2)

    @staticmethod
    def _stream():
        return torch.cuda.current_stream().cuda_stream


def _same(a, b):
    assert torch.equal(a[0], b[0]), (a[0] - b[0]).abs().max()
    assert torch.equal(a[1], b[1]), (a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.parametrize("case", ["subset", "subset_exposure", "polish_k4",
                                  "doubled"])
def test_graphed_refine_matches_eager_bit_for_bit(case, cuda_device,
                                                  monkeypatch):
    params, alive = _map(20000, cuda_device, seed=1)
    tau = [0.012, -0.01, 0.008, 0.01, -0.006, 0.007]
    gt = _frame(params, alive, tau, cuda_device)
    rels = _candidates(tau, cuda_device)
    kw = dict(TUM_TRACK, iterations=24)
    med = np.inf
    if case == "subset_exposure":
        kw.update(enable_exposure=True)
    elif case == "polish_k4":
        kw.update(polish_iters=8, polish_frac=0.5, pose_grad_kernel=True,
                  enable_exposure=True, stale_best_cnt=14)
    elif case == "doubled":
        med = 1e-9      # the best candidate's losses far above: 2x budget
    tcfg = T.TrackerConfig(**kw)
    before = cs.counts()
    eager = _track(params, alive, rels, gt, tcfg, None, med)
    mid = cs.counts()
    graph = T.RefineGraph(cuda_device)
    entries = _Entries(monkeypatch)
    graphed = _track(params, alive, rels, gt, tcfg, graph, med)
    after = cs.counts()
    torch.cuda.synchronize()
    _same(eager, graphed)
    iters = int(eager[2][3])
    if case == "polish_k4":
        phases, backward, kid = 2, "pose_launches", "K4"
    else:
        phases, backward, kid = 1, "bwd_launches", "K2"
        assert iters == (48 if case == "doubled" else 24)
    assert graph.tally() == (phases, iters - phases)
    # The graphed iterations launch the eager loop's kernels.
    for k in before:
        assert after[k] - mid[k] == mid[k] - before[k], k
    assert mid[backward] - before[backward] == iters
    # Each through its entry point, on the loop's stream, K2 / K4 after
    # the K1 whose `out` it takes (the candidates' scoring before them).
    loop = torch.cuda.current_stream().cuda_stream
    refine = entries.calls[-2 * iters:]
    assert [c[0] for c in refine] == ["K1", kid] * iters
    assert all(stream == loop and paired for _, stream, paired in refine)


def test_graph_recaptures_for_a_new_layout_and_counts(cuda_device):
    """One runner, two frames on maps of 12,000 and 30,000 gaussians (the
    frozen layout's width changes), then Tracker.track's counters."""
    tcfg = T.TrackerConfig(**TUM_TRACK, iterations=16, enable_exposure=True)
    graph = T.RefineGraph(cuda_device)
    for n, seed in ((12000, 2), (30000, 3)):
        params, alive = _map(n, cuda_device, seed)
        tau = [0.006, 0.004, -0.01, -0.008, 0.01, 0.004]
        gt = _frame(params, alive, tau, cuda_device)
        rels = _candidates(tau, cuda_device)
        eager = _track(params, alive, rels, gt, tcfg, None)
        graphed = _track(params, alive, rels, gt, tcfg, graph)
        _same(eager, graphed)
        assert graph.tally() == (1, int(eager[2][3]) - 1)
    tracker = T.Tracker(tcfg, RCFG, TUM)
    tracing.enable()
    tracker.track(params, alive, np.eye(4),
                  {"previous": np.linalg.inv(se3_exp(torch.tensor(tau))
                                             .double().numpy())},
                  *gt)
    got = {c["name"]: c["n"] for c in tracing.drain()["counters"]}
    assert got["track.graph_captures"] == 1
    assert got["track.graph_replays"] == got["track.iters"] - 1 > 0


def _pool_bytes(pool) -> int:
    """The bytes the caching allocator reserves for the private pool."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


@pytest.mark.parametrize("shape", ["tum", "replica"])
def test_graphed_frames_hold_no_more_memory(shape, cuda_device):
    """5 tracked frames at a benchmark cell's shape, eager then graphed (one
    runner), each from the memory allocated and reserved at its start: the
    graphed allocated peak is within 16 MiB of the eager one, and after the
    frames the graphed run holds within 1 MiB of the eager's allocation."""
    cam, n = (TUM, 50000) if shape == "tum" else (REPLICA, 150000)
    params, alive = _map(n, cuda_device, seed=4)
    tcfg = T.TrackerConfig(**dict(TUM_TRACK, early_stop_cnt=5),
                           iterations=60, enable_exposure=True)
    frames = []
    for f in range(5):
        tau = [0.004 * f, -0.003 * f, 0.002, 0.005 * f, 0.002, -0.004 * f]
        frames.append((_frame(params, alive, tau, cuda_device, cam),
                       _candidates(tau, cuda_device)))
    _track(params, alive, frames[0][1], frames[0][0], tcfg, None, cam=cam)

    def peaks(graph):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        base_reserved = torch.cuda.memory_reserved()
        for gt, rels in frames:
            _track(params, alive, rels, gt, tcfg, graph, cam=cam)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base,
                torch.cuda.max_memory_reserved() - base_reserved,
                torch.cuda.memory_allocated() - base)

    eager = peaks(None)
    graph = T.RefineGraph(cuda_device)
    graphed = peaks(graph)
    print(f"\n{shape}, 5 frames, over the start: allocated peak eager "
          f"{eager[0] / MIB:.3f} MiB, graphed {graphed[0] / MIB:.3f} MiB; "
          f"reserved peak eager {eager[1] / MIB:.3f} MiB, graphed "
          f"{graphed[1] / MIB:.3f} MiB; the graph pool reserves "
          f"{_pool_bytes(graph.pool) / MIB:.3f} MiB; allocated after the "
          f"frames eager {eager[2] / MIB:.3f} MiB, graphed "
          f"{graphed[2] / MIB:.3f} MiB")
    assert graphed[0] <= eager[0] + 16 * MIB
    # Between frames the graph holds only its pool's free blocks (and
    # what a capture registers outside the pool, read at 1 KiB).
    assert graphed[2] <= eager[2] + MIB
