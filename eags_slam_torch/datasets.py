"""Frame sources of the port (port of eags_slam_tpu.datasets).

  - `BaseDataset`: intrinsics, `cam.crop_edge` (the map camera is the full
    camera cropped; the VO reads the uncropped frame), GT poses, and the
    frame API every consumer uses: `frame(idx)` (the cropped float32 colour
    and depth on the dataset's device), `frame_u8(idx)` (the uncropped uint8
    colour and float32 depth on the device, the VO's input) and
    `dataset[idx]` (the cropped host frame, as the JAX package returns it).
  - `FileDataset`: the readers' base. `start_prefetch` reads ahead with
    the native decode pool (`utils/native_loader.py`: JPEG / PNG colour and
    16-bit PNG depth decoded by C++ threads, outside the GIL) when its
    library loads, the files are its formats and the reader keeps the
    base `_load_raw`; else with a preloader thread whose frames
    `utils/image_io.py` decodes (PNG and TIFF with zlib and numpy, JPEG
    through Pillow; `data.prefetch` frames ahead, at most twice that held;
    an evicted frame is decoded again on request, from any thread). Colour
    is undistorted with `cam.distortion` (the 5-coefficient OpenCV model,
    maps built on first use) on either path, after the native pool's
    decode. `report()["reader"]` says which ran. Uploads go through pinned
    memory, non-blocking, on the caller's current CUDA stream.
  - The readers: `Replica`, `TUM_RGBD`, `ScanNet`, `ScanNetPP` (its resize
    to 640 x 480 uses Pillow, as the JAX package's does).
  - `Synthetic`: the procedural gaussian-splat room with exact GT poses: the
    scene and trajectory come from numpy with the config's seed (the same
    numbers as the JAX package), and the frames are rendered on the
    config's device with this package's sorted renderer (the K1 kernel on
    the card), quantised as the JAX dataset quantises them (uint8 colour,
    float16 depth of alpha > 0.5 pixels), once at start-up. The ray-cast
    `synthetic_hard` scene is in `synthetic_hard.py`.
  - `ArrayDataset` wraps frames that already exist as arrays (e.g. another
    implementation's frames, for parity tests).

The device is the config's `device` ("cuda" by default) unless the caller
names one. Depth is uploaded as float32 (the JAX package rounds it to
float16 to spare its TPU link).
"""
from __future__ import annotations

import math
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .core.camera import Camera
from .utils import native_loader
from .utils.image_io import pillow_image, read_image

# The host frames' dtypes (colour, depth) as torch dtypes.
_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.float32): torch.float32}


def room_scene(seed: int, n_per_wall: int) -> Dict[str, np.ndarray]:
    """The synthetic room: a box whose six walls carry jittered coloured
    gaussians (numpy, same draws as the JAX dataset for the same seed)."""
    rng = np.random.default_rng(seed)
    half = 2.0
    walls, colors = [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            p = rng.uniform(-half, half, (n_per_wall, 3)).astype(np.float32)
            p[:, axis] = sign * half + rng.normal(0, 0.01, n_per_wall)
            walls.append(p)
            base = rng.uniform(0.2, 0.9, 3).astype(np.float32)
            c = np.clip(base + rng.normal(0, 0.18, (n_per_wall, 3)),
                        0.05, 1.0).astype(np.float32)
            colors.append(c)
    xyz = np.concatenate(walls)
    rgb = np.concatenate(colors)
    n = xyz.shape[0]
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return dict(
        means=xyz, quats=q,
        log_scales=np.log(rng.uniform(0.06, 0.16, (n, 3))).astype(np.float32),
        opac=rng.uniform(2.0, 6.0, (n, 1)).astype(np.float32),
        colors=rgb,
    )


def orbit_poses(n_frames: int, orbit_speed: float) -> List[np.ndarray]:
    """Smooth orbit around the room centre (c2w, float64)."""
    poses = []
    for i in range(n_frames):
        t = i * orbit_speed
        ang = 0.6 * math.sin(2 * math.pi * t)
        c2w = np.eye(4)
        c2w[:3, :3] = np.array([[math.cos(ang), 0, math.sin(ang)],
                                [0, 1, 0],
                                [-math.sin(ang), 0, math.cos(ang)]])
        c2w[:3, 3] = [0.5 * math.sin(2 * math.pi * t),
                      0.1 * math.sin(4 * math.pi * t),
                      0.5 * math.cos(2 * math.pi * t)]
        poses.append(c2w)
    return poses


def distort_points(xy: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Apply the 5-coefficient OpenCV distortion model (k1,k2,p1,p2,k3) to
    NORMALIZED image coordinates xy (..., 2) -> distorted normalized coords.

    This is the forward model used by `cv2.undistort` (reference applies it
    at preload: src/entities/datasets.py:229-230, 292-293)."""
    k1, k2, p1, p2, k3 = [float(v) for v in dist[:5]]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def undistort_maps(camera: "Camera", dist: np.ndarray):
    """Precompute the source-pixel sampling grid for undistortion.

    For each OUTPUT (rectified) pixel, push its normalized coordinate through
    the forward distortion model to find where in the DISTORTED source image
    to sample — exactly `cv2.initUndistortRectifyMap(K, dist, I, K, ...)`
    (the new camera matrix equals K, as in `cv2.undistort`'s default and the
    reference's call).

    Returns (map_u, map_v) float32 (H, W): source pixel coords.
    """
    H, W = camera.height, camera.width
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    xy = np.stack([(u - camera.cx) / camera.fx, (v - camera.cy) / camera.fy],
                  axis=-1)
    xyd = distort_points(xy, np.asarray(dist, np.float64))
    map_u = (camera.fx * xyd[..., 0] + camera.cx).astype(np.float32)
    map_v = (camera.fy * xyd[..., 1] + camera.cy).astype(np.float32)
    return map_u, map_v


def remap_bilinear(img: np.ndarray, map_u: np.ndarray, map_v: np.ndarray) -> np.ndarray:
    """Bilinear resample `img` (H, W[, C]) at source coords (map_u, map_v);
    out-of-bounds samples clamp to the border (cv2.remap BORDER_CONSTANT vs
    clamp only differs in the outermost invalid ring, which crop_edge removes
    — every TUM/ScanNet config crops >= 8 px)."""
    H, W = img.shape[:2]
    u0 = np.floor(map_u).astype(np.int32)
    v0 = np.floor(map_v).astype(np.int32)
    fu = (map_u - u0)[..., None] if img.ndim == 3 else (map_u - u0)
    fv = (map_v - v0)[..., None] if img.ndim == 3 else (map_v - v0)
    u0c = np.clip(u0, 0, W - 1)
    u1c = np.clip(u0 + 1, 0, W - 1)
    v0c = np.clip(v0, 0, H - 1)
    v1c = np.clip(v0 + 1, 0, H - 1)
    a = img[v0c, u0c].astype(np.float32)
    b = img[v0c, u1c].astype(np.float32)
    c = img[v1c, u0c].astype(np.float32)
    d = img[v1c, u1c].astype(np.float32)
    out = (a * (1 - fu) + b * fu) * (1 - fv) + (c * (1 - fu) + d * fu) * fv
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(out + 0.5, 0, 255).astype(img.dtype)
    return out.astype(img.dtype)


class BaseDataset:
    """Camera, crop, GT poses and the frame API. The frames themselves live
    in `_frames` as device tensors (uint8 colour, float depth), uncropped;
    `FileDataset` reads them from files instead."""

    def __init__(self, config: Dict, device=None):
        cam = config["cam"]
        self.device = torch.device(device if device is not None
                                   else config.get("device", "cuda"))
        self.crop_edge = int(cam.get("crop_edge", 0))
        self.full_camera = Camera(cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                                  cam["W"], cam["H"])
        self.camera = (self.full_camera.crop(self.crop_edge)
                       if self.crop_edge else self.full_camera)
        self.depth_scale = float(cam.get("depth_scale", 1.0))
        self.frame_limit = int(config.get("frame_limit", -1))
        self.poses: List[np.ndarray] = []
        self.timestamps: List[float] = []
        self._frames: Dict[int, tuple] = {}

    def __len__(self) -> int:
        n = len(self.poses)
        return n if self.frame_limit < 0 else min(n, self.frame_limit)

    def _crop(self, img):
        e = self.crop_edge
        return img[e:-e, e:-e] if e > 0 else img

    def frame(self, idx: int):
        """(color (H, W, 3) f32 in [0, 1], depth (H, W) f32 metres), cropped
        by `crop_edge`, both on the dataset's device."""
        rgb8, depth = self._frames[idx]
        return (self._crop(rgb8).to(torch.float32) / 255.0,
                self._crop(depth).to(torch.float32))

    def frame_u8(self, idx: int):
        """(color (H, W, 3) uint8, depth (H, W) f32 metres), uncropped, on
        the dataset's device: the VO's input."""
        rgb8, depth = self._frames[idx]
        return rgb8, depth.to(torch.float32)

    def frame_u8_host(self, idx: int):
        """`frame_u8` on the host CPU (the input of a VO pinned there)."""
        rgb8, depth = self._frames[idx]
        return rgb8.cpu(), depth.to(torch.float32).cpu()

    def __getitem__(self, idx: int):
        color, depth = self.frame(idx)
        return (idx, color.cpu().numpy(), depth.cpu().numpy(),
                np.asarray(self.poses[idx], np.float64))

    def start_prefetch(self):
        """Frames already live on the device: nothing to read ahead."""

    def report(self) -> Dict:
        return {}

    def close(self):
        self._frames.clear()


class FileDataset(BaseDataset):
    """Frames read from files (port of the JAX BaseDataset's file path):
    decoded on the host, colour undistorted, read ahead by the preloader
    thread, uploaded on request. Subclasses fill `color_paths`,
    `depth_paths`, `poses` and `timestamps`."""

    def __init__(self, config: Dict, device=None):
        super().__init__(config, device)
        # Lens undistortion (reference datasets.py:229-230/:292-293 +
        # configs/TUM_RGBD/*.yaml `distortion:`): colour only, depth is
        # left untouched (TUM registered depth is produced rectified).
        dist = config["cam"].get("distortion")
        self.distortion = (np.asarray(dist, np.float64)
                           if dist is not None and np.any(np.asarray(dist))
                           else None)
        self._undist_maps: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.color_paths: list = []
        self.depth_paths: list = []
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._cv = threading.Condition(threading.Lock())
        self._cancel = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prefetch_ahead = int(config.get("data", {}).get("prefetch", 8))
        self._loaded_until = -1      # highest index the preloader produced
        self._error: Optional[BaseException] = None   # what stopped it
        self._decode_s = 0.0
        self._decoded = 0
        self._native = None      # the native decode pool (start_prefetch)
        self._native_status: Optional[Dict] = None   # its library's, if tried
        self._reader = "python"  # the reader start_prefetch chose

    def __len__(self) -> int:
        n = len(self.color_paths) if self.color_paths else len(self.poses)
        return n if self.frame_limit < 0 else min(n, self.frame_limit)

    # -- decoding (any thread) ----------------------------------------------
    def _load_raw(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(rgb uint8 (H, W, 3) undistorted, depth f32 metres), uncropped."""
        rgb = read_image(self.color_paths[idx])[..., :3]
        depth = read_image(self.depth_paths[idx]).astype(np.float32) \
            / self.depth_scale
        return self._undistort_color(rgb), depth

    def _undistort_color(self, rgb: np.ndarray) -> np.ndarray:
        if self.distortion is None:
            return rgb
        with self._cv:
            if self._undist_maps is None:
                self._undist_maps = undistort_maps(self.full_camera,
                                                   self.distortion)
            maps = self._undist_maps
        return remap_bilinear(rgb, *maps)

    def _decode(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        t0 = time.perf_counter()
        frame = self._load_raw(idx)
        dt = time.perf_counter() - t0
        with self._cv:
            self._decode_s += dt
            self._decoded += 1
        return frame

    # -- the preloader ------------------------------------------------------
    def start_prefetch(self):
        if self._thread is not None or self._native is not None \
                or len(self) == 0:
            return
        # The native pool decodes the raw files; a reader with its own
        # _load_raw (ScanNet++'s resize) keeps the Python path.
        colors, depths = self.color_paths[: len(self)], \
            self.depth_paths[: len(self)]
        if (type(self)._load_raw is FileDataset._load_raw
                and native_loader.supported(colors, depths)):
            self._native = native_loader.try_create(
                colors, depths, self.depth_scale, self._prefetch_ahead)
            self._native_status = native_loader.status()
            if self._native is not None:
                self._reader = "native"
                return

        def worker():
            for i in range(len(self)):
                if self._cancel.is_set():
                    return
                try:
                    frame = self._decode(i)
                except BaseException as e:   # re-raised by the reader
                    with self._cv:
                        self._error = e
                        self._cv.notify_all()
                    return
                with self._cv:
                    self._cache[i] = frame
                    self._loaded_until = i
                    self._cv.notify_all()
                    # Bound memory: wait while too far ahead of consumers.
                    while (len(self._cache) > 2 * self._prefetch_ahead
                           and not self._cancel.is_set()):
                        self._cv.wait(timeout=0.5)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="eags-preloader")
        self._thread.start()

    def close(self):
        self._cancel.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._native is not None:
            self._native.close()
            self._native = None
        self._cache.clear()

    def _get_frame(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        native = self._native
        if native is not None:
            try:
                rgb, depth = native.get(idx)
            except RuntimeError as e:
                raise RuntimeError(f"{e}: {self.color_paths[idx]}, "
                                   f"{self.depth_paths[idx]}") from e
            return self._undistort_color(rgb), depth
        if self._thread is None:
            return self._decode(idx)
        with self._cv:
            # Wait only for frames the preloader has not reached yet;
            # already-evicted older frames are decoded again (the loop
            # closer revisits keyframes long after the loop passed them).
            # Frames older than the read point are released (the SLAM loop
            # reads in order), also while waiting, so that a read further
            # ahead than the cache bound lets the preloader through.
            while True:
                for k in [k for k in self._cache if k < idx - 1]:
                    del self._cache[k]
                self._cv.notify_all()
                if (idx in self._cache or idx <= self._loaded_until
                        or self._cancel.is_set()):
                    break
                if self._error is not None:
                    # The preloader stopped on a frame at or before idx:
                    # its error (naming the file) is this read's.
                    raise self._error
                self._cv.wait(timeout=0.5)
            frame = self._cache.get(idx)
        if frame is None:
            return self._decode(idx)
        return frame

    # -- the frame API --------------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the device: through pinned memory, non-blocking
        on the caller's current stream (on the CPU, a copy)."""
        if self.device.type == "cuda":
            host = torch.empty(arr.shape, dtype=_TORCH_DTYPES[arr.dtype],
                               pin_memory=True)
            host.numpy()[...] = arr
            return host.to(self.device, non_blocking=True)
        return torch.from_numpy(np.array(arr)).to(self.device)

    def frame(self, idx: int):
        rgb, depth = self._get_frame(idx)
        return (self._upload(self._crop(rgb)).to(torch.float32) / 255.0,
                self._upload(self._crop(depth)))

    def frame_u8(self, idx: int):
        rgb, depth = self._get_frame(idx)
        return self._upload(rgb), self._upload(depth)

    def frame_u8_host(self, idx: int):
        rgb, depth = self._get_frame(idx)
        return torch.from_numpy(np.array(rgb)), torch.from_numpy(
            np.array(depth))

    def get_origin_image(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """The uncropped host frame: (rgb uint8 (H, W, 3), depth f32)."""
        return self._get_frame(idx)

    def __getitem__(self, idx: int):
        rgb, depth = self._get_frame(idx)
        color = self._crop(rgb).astype(np.float32) / 255.0
        pose = (np.asarray(self.poses[idx], np.float64) if self.poses
                else np.eye(4))
        return idx, color, self._crop(depth).astype(np.float32), pose

    def report(self) -> Dict:
        """The reader that ran ("native" or "python"), the number of Python
        decodes and their mean time (host clock, any thread; null under the
        native pool, which decodes off the Python threads), and the native
        library's status (`native_loader.status()`) when the pool was tried,
        else null."""
        with self._cv:
            n, s = self._decoded, self._decode_s
        native = self._reader == "native"
        return {"reader": self._reader, "decoded": n,
                "decode_ms_avg": None if native else
                (1e3 * s / n if n else 0.0),
                "native": self._native_status}


class Replica(FileDataset):
    """Replica (reference datasets.py:85-134): results/frame%06d.jpg,
    depth%06d.png at depth_scale, traj.txt rows of flattened 4x4 c2w."""

    def __init__(self, config: Dict, device=None):
        super().__init__(config, device)
        root = Path(config["data"]["input_path"])
        self.color_paths = sorted((root / "results").glob("frame*.jpg"))
        self.depth_paths = sorted((root / "results").glob("depth*.png"))
        traj = np.loadtxt(root / "traj.txt").reshape(-1, 4, 4)
        self.poses = [traj[i] for i in range(len(self.color_paths))]
        self.timestamps = [i / 30.0 for i in range(len(self.color_paths))]


class TUM_RGBD(FileDataset):
    """TUM RGB-D (reference datasets.py:136-255): associates rgb/depth/gt by
    timestamp (max_dt 0.08), poses made relative to the first frame."""

    def __init__(self, config: Dict, device=None):
        super().__init__(config, device)
        root = Path(config["data"]["input_path"])
        rgb_list = self._read_file_list(root / "rgb.txt")
        depth_list = self._read_file_list(root / "depth.txt")
        pose_list = self._read_file_list(root / "groundtruth.txt")
        assoc = self._associate(rgb_list, depth_list)
        frame_rate = config["data"].get("frame_rate", 32)
        min_gap = (1.0 / frame_rate) if frame_rate > 0 else 0.0

        poses_t = np.array(sorted(pose_list.keys()))
        first_inv = None
        last_t = -np.inf
        for (t_rgb, t_depth) in assoc:
            # Take a frame when the timestamp gap since the last selected
            # one exceeds 1/frame_rate (reference datasets.py:185-190).
            if t_rgb - last_t < min_gap:
                continue
            last_t = t_rgb
            t = poses_t[np.argmin(np.abs(poses_t - t_rgb))]
            if abs(t - t_rgb) > 0.08:
                continue
            c2w = self._tum_pose(pose_list[t])
            if first_inv is None:
                first_inv = np.linalg.inv(c2w)
            self.color_paths.append(root / rgb_list[t_rgb][0])
            self.depth_paths.append(root / depth_list[t_depth][0])
            self.poses.append(first_inv @ c2w)
            self.timestamps.append(t_rgb)

    @staticmethod
    def _read_file_list(path) -> Dict[float, list]:
        out = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                out[float(parts[0])] = parts[1:]
        return out

    @staticmethod
    def _associate(a: Dict, b: Dict, max_dt: float = 0.08):
        pairs = []
        b_keys = np.array(sorted(b.keys()))
        for t in sorted(a.keys()):
            j = np.argmin(np.abs(b_keys - t))
            if abs(b_keys[j] - t) < max_dt:
                pairs.append((t, float(b_keys[j])))
        return pairs

    @staticmethod
    def _tum_pose(vals) -> np.ndarray:
        tx, ty, tz, qx, qy, qz, qw = [float(v) for v in vals[:7]]
        # quaternion (x,y,z,w) -> rotation
        x, y, z, w = qx, qy, qz, qw
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = [tx, ty, tz]
        return T


class ScanNet(FileDataset):
    """Preprocessed ScanNet (reference datasets.py:257-318 +
    scripts/scannet_preprocess.py): rgb/*.png, depth/*.TIFF (f32 metres),
    gt_pose.txt in TUM format."""

    def __init__(self, config: Dict, device=None):
        super().__init__(config, device)
        root = Path(config["data"]["input_path"])
        self.color_paths = sorted((root / "rgb").glob("*.png"),
                                  key=lambda p: int(p.stem))
        self.depth_paths = sorted((root / "depth").glob("*.TIFF"),
                                  key=lambda p: int(p.stem))
        gt = np.loadtxt(root / "gt_pose.txt")
        for row in gt:
            self.poses.append(TUM_RGBD._tum_pose(row[1:8]))
            self.timestamps.append(float(row[0]))
        self.depth_scale = 1.0  # depths already metric f32 TIFF


class ScanNetPP(FileDataset):
    """ScanNet++ DSLR (reference datasets.py:320-399): undistorted images +
    nerfstudio transforms.json, resized to 640x480 through Pillow (imported
    when a frame is read); the held-out `test_frames` for the novel-view
    evaluation."""

    def __init__(self, config: Dict, device=None):
        super().__init__(config, device)
        import json

        root = Path(config["data"]["input_path"])
        with open(root / "dslr" / "nerfstudio"
                  / "transforms_undistorted.json") as f:
            meta = json.load(f)
        self.target_wh = (640, 480)
        frames = meta["frames"]
        frames.sort(key=lambda fr: fr["file_path"])
        # OpenGL->OpenCV camera convention flip (nerfstudio stores OpenGL).
        flip = np.diag([1.0, -1.0, -1.0, 1.0])
        sx = self.target_wh[0] / meta["w"]
        sy = self.target_wh[1] / meta["h"]
        self.full_camera = Camera(
            meta["fl_x"] * sx, meta["fl_y"] * sy, meta["cx"] * sx,
            meta["cy"] * sy, self.target_wh[0], self.target_wh[1])
        self.camera = (self.full_camera.crop(self.crop_edge)
                       if self.crop_edge else self.full_camera)
        for fr in frames:
            name = os.path.basename(fr["file_path"])
            self.color_paths.append(root / "dslr" / "undistorted_images"
                                    / name)
            self.depth_paths.append(root / "dslr" / "undistorted_depths"
                                    / name.replace(".JPG", ".png"))
            self.poses.append(np.asarray(fr["transform_matrix"]) @ flip)
        self.test_ids = set(meta.get("test_frames", []))
        self.depth_scale = 1000.0

    def _load_raw(self, idx):
        Image = pillow_image(self.color_paths[idx])
        with Image.open(str(self.color_paths[idx])) as im:
            rgb = np.asarray(im.convert("RGB").resize(self.target_wh,
                                                      Image.BILINEAR))
        with Image.open(str(self.depth_paths[idx])) as im:
            depth = np.asarray(im.resize(self.target_wh, Image.NEAREST),
                               np.float32) / self.depth_scale
        return rgb, depth


class Synthetic(BaseDataset):
    """Procedural gaussian-splat room rendered with the port's renderer."""

    def __init__(self, config: Dict, device=None):
        super().__init__(config, device)
        from .ops.rasterizer import RasterConfig, render

        d = config["data"]
        self.n_frames = int(d.get("n_frames", 40))
        scene = room_scene(int(config.get("seed", 0)),
                           int(d.get("gaussians_per_wall", 700)))
        self.n_scene = scene["means"].shape[0]
        self.poses = orbit_poses(self.n_frames,
                                 float(d.get("orbit_speed", 1.0 / 300.0)))
        self.timestamps = [i / 30.0 for i in range(self.n_frames)]
        cfg = RasterConfig(tile=16, dup_side=4)
        t = {k: torch.as_tensor(v, device=self.device)
             for k, v in scene.items()}
        with torch.no_grad():
            for i in range(len(self)):
                w2c = torch.as_tensor(np.linalg.inv(self.poses[i]),
                                      dtype=torch.float32, device=self.device)
                out = render(t["means"], t["quats"], t["log_scales"],
                             t["opac"], t["colors"], w2c, self.full_camera,
                             cfg)
                rgb8 = torch.clamp(out.color * 255.0 + 0.5, 0, 255).to(
                    torch.uint8)
                depth = torch.where(
                    out.alpha > 0.5,
                    out.depth / torch.clamp(out.alpha, min=1e-6),
                    torch.zeros_like(out.depth)).to(torch.float16)
                self._frames[i] = (rgb8, depth)

    def __len__(self):
        return self.n_frames if self.frame_limit < 0 else min(
            self.n_frames, self.frame_limit)


class ArrayDataset(BaseDataset):
    """Frames given as arrays: colour uint8 (N, H, W, 3), depth float
    (N, H, W), GT c2w poses (N, 4, 4)."""

    def __init__(self, config: Dict, colors_u8, depths, poses, device=None):
        super().__init__(config, device)
        self.poses = [np.asarray(p, np.float64) for p in poses]
        self.timestamps = [i / 30.0 for i in range(len(self.poses))]
        for i in range(len(self)):
            self._frames[i] = (
                torch.as_tensor(np.asarray(colors_u8[i], np.uint8),
                                device=self.device),
                torch.as_tensor(np.asarray(depths[i], np.float32),
                                device=self.device))


def get_dataset(name: str):
    """The dataset class for a config's `data.dataset_name` (reference
    datasets.py:401-416)."""
    name = name.lower()
    if name == "synthetic_hard":
        from .synthetic_hard import SyntheticHard  # lazy: avoids circularity

        return SyntheticHard
    return {
        "replica": Replica,
        "tum_rgbd": TUM_RGBD,
        "scannet": ScanNet,
        "scannetpp": ScanNetPP,
        "synthetic": Synthetic,
    }[name]
