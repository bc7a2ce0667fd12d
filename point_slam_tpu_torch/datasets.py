"""Host-side RGB-D frames (numpy): the Replica, ScanNet and TUM-RGBD disk
readers, the procedural synthetic scene and the sensor-quantised wire
format.

The port of ``point_slam_tpu.datasets``, with its reads in the same order:
decode (BGR u8), undistort the u8 colour (TUM's ``cam.distortion``),
BGR -> RGB / 255 in f64, resize the colour to the depth's size, resize
both to ``cam.crop_size`` (bilinear colour, nearest depth), crop
``crop_edge``, and the Y/Z pose-axis flip of every loader. The JAX readers
call OpenCV for the decode and the resampling; the port calls its own
(``utils/imgcodec.py``, ``common/image.py``), which give OpenCV's bytes.
Every frame is sensor-quantised: u8 colour and u16 depth at
``png_depth_scale``. ``wire(i)`` returns the compact (H,W,5) u8 array for
the host->device transfer; ``__getitem__`` returns its f32 dequantisation,
so the host and device paths see bit-identical values.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from point_slam_tpu_torch.common import image
from point_slam_tpu_torch.utils.imgcodec import imread


def dequantize_wire(packed: np.ndarray, inv_scale: np.float32):
    """Host decode of a wire frame: (H,W,5) u8 -> (color f32 [0,1],
    depth f32 meters). Channels 0..2 are u8 color; channels 3..4 are the
    little-endian bytes of u16 depth. Mirrored on device by
    common.image.decode_wire_frame (same f32 multiplies -> bit-identical)."""
    color = packed[..., :3].astype(np.float32) * np.float32(1.0 / 255.0)
    du16 = np.ascontiguousarray(packed[..., 3:5]).view(np.uint16)[..., 0]
    return color, du16.astype(np.float32) * inv_scale


def _flip_yz(c2w: np.ndarray) -> np.ndarray:
    """Rotate the camera frame 180 deg about X: the codebase convention is
    x right, y up, z backward while the datasets store y down / z
    forward."""
    c2w = c2w.copy()
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    return c2w


class BaseDataset:
    def __init__(self, cfg, input_folder: Optional[str] = None):
        self.name = cfg["dataset"]
        cam = cfg["cam"]
        self.png_depth_scale = cam["png_depth_scale"]
        self.H, self.W = cam["H"], cam["W"]
        self.fx, self.fy, self.cx, self.cy = (cam["fx"], cam["fy"],
                                              cam["cx"], cam["cy"])
        self.distortion = (np.array(cam["distortion"]) if "distortion" in cam
                           else None)
        self.crop_size = cam.get("crop_size")
        self.crop_edge = cam["crop_edge"] or 0
        self.input_folder = input_folder or cfg["data"]["input_folder"]
        self.color_paths: List[str] = []
        self.depth_paths: List[str] = []
        self.poses = []

    def __len__(self):
        return self.n_img

    def _read_color(self, path):
        img = imread(path)
        if self.distortion is not None:
            img = image.undistort(img, self.fx, self.fy, self.cx, self.cy,
                                  self.distortion)
        return img[..., ::-1].astype(np.float64) / 255.0

    def _read_depth(self, path):
        return imread(path, unchanged=True).astype(np.float32) \
            / self.png_depth_scale

    def _frame_arrays(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """Preprocessed (color f32, depth f32) before wire quantisation."""
        color = self._read_color(self.color_paths[index])
        depth = self._read_depth(self.depth_paths[index])
        h, w = depth.shape
        color = image.resize_linear(color, w, h)
        if self.crop_size is not None:
            ch, cw = self.crop_size
            color = image.resize_linear(color, cw, ch)
            depth = image.resize_nearest(depth, cw, ch)
        e = self.crop_edge
        if e > 0:
            color = color[e:-e, e:-e]
            depth = depth[e:-e, e:-e]
        return color.astype(np.float32), depth.astype(np.float32)

    @property
    def depth_inv_scale(self) -> np.float32:
        return np.float32(1.0 / float(self.png_depth_scale))

    def wire(self, index: int):
        """Compact transfer form: (index, (H,W,5) u8, c2w f32) — u8 color
        in channels 0..2 and u16 depth (at png_depth_scale) as two
        little-endian bytes in channels 3..4, so one frame is one
        host->device copy at sensor width. ``__getitem__`` dequantizes
        this, so the host and device paths agree bit-exactly."""
        color, depth = self._frame_arrays(index)
        cu8 = np.clip(np.rint(color * np.float32(255.0)), 0, 255) \
            .astype(np.uint8)
        dq = np.rint(depth * np.float32(self.png_depth_scale))
        if dq.max(initial=0.0) > 65535.0:
            # out-of-lattice depth would silently saturate far geometry —
            # surface it loudly instead (e.g. a scene deeper than
            # 65535/png_depth_scale metres)
            import warnings
            warnings.warn(
                f"frame {index}: depth {depth.max():.2f} m exceeds the u16 "
                f"wire lattice ({65535.0 / float(self.png_depth_scale):.2f} m"
                f" at png_depth_scale={self.png_depth_scale}); far geometry "
                "will be clipped", RuntimeWarning, stacklevel=2)
        du16 = np.clip(dq, 0, 65535).astype(np.uint16)
        packed = np.concatenate([cu8, du16[..., None].view(np.uint8)],
                                axis=-1)
        return index, packed, self.poses[index].astype(np.float32)

    def __getitem__(self, index: int):
        _, packed, pose = self.wire(index)
        color, depth = dequantize_wire(packed, self.depth_inv_scale)
        return index, color, depth, pose


class Replica(BaseDataset):
    def __init__(self, cfg, input_folder=None):
        super().__init__(cfg, input_folder)
        self.color_paths = sorted(
            glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(
            glob.glob(f"{self.input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        with open(f"{self.input_folder}/traj.txt") as f:
            lines = f.readlines()
        self.poses = [
            _flip_yz(np.array(list(map(float, lines[i].split())))
                     .reshape(4, 4))
            for i in range(self.n_img)]


class ScanNet(BaseDataset):
    def __init__(self, cfg, input_folder=None):
        super().__init__(cfg, input_folder)
        self.input_folder = os.path.join(self.input_folder, "frames")

        def bynum(p):
            return int(os.path.basename(p).split(".")[0])

        def listed(sub, ext):
            return sorted(glob.glob(os.path.join(self.input_folder, sub,
                                                 f"*.{ext}")), key=bynum)

        self.color_paths = listed("color", "jpg")
        self.depth_paths = listed("depth", "png")
        self.n_img = len(self.color_paths)
        self.poses = [_flip_yz(np.loadtxt(p).reshape(4, 4))
                      for p in listed("pose", "txt")]


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """(x, y, z, w) quaternion -> 3x3 rotation, normalised first, as
    ``scipy.spatial.transform.Rotation.from_quat(q).as_matrix()``."""
    x, y, z, w = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [x * x - y * y - z * z + w * w, 2 * (x * y - z * w),
         2 * (x * z + y * w)],
        [2 * (x * y + z * w), -x * x + y * y - z * z + w * w,
         2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w),
         -x * x - y * y + z * z + w * w]])


class TUM_RGBD(BaseDataset):
    def __init__(self, cfg, input_folder=None, frame_rate=32):
        super().__init__(cfg, input_folder)
        self.color_paths, self.depth_paths, self.poses = self._load(
            self.input_folder, frame_rate)
        self.n_img = len(self.color_paths)

    @staticmethod
    def _parse_list(path, skiprows=0):
        return np.loadtxt(path, delimiter=" ", dtype=np.str_,
                          skiprows=skiprows)

    @staticmethod
    def _associate(t_img, t_depth, t_pose, max_dt=0.08):
        """(rgb, depth, pose) row triples whose nearest depth and pose
        stamps lie within ``max_dt`` of the rgb stamp."""
        out = []
        for i, t in enumerate(t_img):
            j = np.argmin(np.abs(t_depth - t))
            k = np.argmin(np.abs(t_pose - t))
            if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                out.append((i, j, k))
        return out

    def _load(self, folder, frame_rate):
        """Associated frames picked at most ``frame_rate`` a second, poses
        relative to the first (made the identity), then flipped."""
        gt = os.path.join(folder, "groundtruth.txt")
        pose_file = gt if os.path.isfile(gt) else os.path.join(folder,
                                                                "pose.txt")
        img_data = self._parse_list(os.path.join(folder, "rgb.txt"))
        depth_data = self._parse_list(os.path.join(folder, "depth.txt"))
        pose_data = self._parse_list(pose_file, skiprows=1)
        pose_vecs = pose_data[:, 1:].astype(np.float64)
        t_img = img_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        assoc = self._associate(t_img, t_depth, t_pose)

        picks = [0]
        for i in range(1, len(assoc)):
            t0 = t_img[assoc[picks[-1]][0]]
            t1 = t_img[assoc[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                picks.append(i)

        images, depths, poses = [], [], []
        inv_first = None
        for ix in picks:
            i, j, k = assoc[ix]
            images.append(os.path.join(folder, img_data[i, 1]))
            depths.append(os.path.join(folder, depth_data[j, 1]))
            c2w = np.eye(4)
            c2w[:3, :3] = quat_to_matrix(pose_vecs[k][3:])
            c2w[:3, 3] = pose_vecs[k][:3]
            if inv_first is None:
                inv_first = np.linalg.inv(c2w)
                c2w = np.eye(4)
            else:
                c2w = inv_first @ c2w
            poses.append(_flip_yz(c2w))
        return images, depths, poses


class Synthetic(BaseDataset):
    """Procedural RGB-D room: a textured axis-aligned box observed from a
    circular trajectory. Analytic depth (ray/box intersection) and a smooth
    3D color field give consistent multi-view supervision with exact poses —
    used by the e2e tests and bench.py since the image ships no datasets.
    """

    def __init__(self, cfg, input_folder=None):
        super().__init__(cfg, input_folder)
        syn = cfg.get("synthetic", {})
        self.n_img = syn.get("n_frames", 100)
        self.box = np.array(syn.get("half_extent", [3.0, 2.2, 2.6]))
        self.noise = syn.get("depth_noise", 0.0)
        self.dropout = syn.get("depth_dropout", 0.0)  # fraction of zero-depth
        self.seed = syn.get("seed", 7)
        # interior objects + texture sharpness: an EMPTY smooth-textured box
        # is a pathological tracking scene (translation along a planar wall
        # is constrained only by low-frequency color), unlike Replica rooms;
        # n_objects > 0 places analytic spheres/boxes as "furniture".
        # Defaults (0 objects, freq 1, detail 0) keep legacy frames bit-exact.
        self.n_objects = int(syn.get("objects", 0))
        self.tex_freq = float(syn.get("texture_freq", 1.0))
        self.tex_detail = float(syn.get("texture_detail", 0.0))
        self.spheres, self.boxes = self._place_objects()
        # per-frame angular step; default sweeps 0.6 turns over >=60 frames so
        # inter-frame motion stays SLAM-trackable (a few cm, Replica-like)
        self.ang_step = syn.get("angular_step",
                                2 * np.pi * 0.6 / max(self.n_img, 60))
        self.poses = [self._pose(t) for t in range(self.n_img)]
        self._enforce_camera_clearance()
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def _enforce_camera_clearance(self, margin: float = 0.1):
        """Push interior objects out of the camera path.

        Placement avoids the nominal orbit, but arbitrary seeds/frame counts
        must never start a pose inside (or grazing) an object — a camera
        inside a box degenerates its analytic depth to ~0.
        """
        if not (len(self.spheres) or len(self.boxes)):
            return
        eyes = np.stack([p[:3, 3] for p in self.poses])
        for s in self.spheres:
            d = np.linalg.norm(eyes - s[:3], axis=1).min()
            if d < s[3] + margin:
                s[3] = max(d - margin, 0.05)
        keep = []
        for b in self.boxes:
            lo, hi = b[:3], b[3:]
            c = (lo + hi) / 2
            h = np.maximum((hi - lo) / 2, 1e-6)
            # per-pose Chebyshev-like ratio in box units; <1 means inside
            ratios = (np.abs(eyes - c) / (h + margin)).max(1)
            r_min = ratios.min()
            if r_min <= 1.0:
                # shrink so the closest pose clears the margin-padded box
                f = r_min * 0.9
                if f < 0.3:
                    continue                        # too close to save; drop
                h = h * f
                b[:3] = c - h
                b[3:] = c + h
            keep.append(b)
        self.boxes = (np.asarray(keep, np.float64).reshape(-1, 6)
                      if keep else np.zeros((0, 6)))

    def _pose(self, t):
        ang = self.ang_step * t
        radius = 0.8
        eye = np.array([radius * np.cos(ang), 0.25 * np.sin(2 * ang),
                        radius * np.sin(ang)])
        # look toward a slowly rotating target on the walls
        tgt_ang = ang + 0.9
        target = np.array([2.5 * np.cos(tgt_ang), 0.4 * np.sin(tgt_ang),
                           2.2 * np.sin(tgt_ang)])
        fwd = target - eye
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.eye(4)
        # camera convention: x right, y up, z backward (-z = viewing)
        c2w[:3, 0] = right
        c2w[:3, 1] = up
        c2w[:3, 2] = -fwd
        c2w[:3, 3] = eye
        return c2w

    def _place_objects(self):
        """Deterministic interior furniture: alternating spheres and boxes.

        Kept clear of the camera orbit (radius 0.8 in xz, |y| <= 0.25) so no
        pose ever starts inside an object. Returns (spheres (S,4) cx cy cz r,
        boxes (B,6) lo xyz + hi xyz).
        """
        spheres, boxes = [], []
        if self.n_objects > 0:
            rng = np.random.default_rng(self.seed * 31 + 5)
            for k in range(self.n_objects):
                ang = rng.uniform(0, 2 * np.pi)
                rad = rng.uniform(1.4, 2.3)
                c = np.array([rad * np.cos(ang) * self.box[0] / 3.0,
                              rng.uniform(-1.4, 0.9),
                              rad * np.sin(ang) * self.box[2] / 3.0])
                c = np.clip(c, -self.box + 0.55, self.box - 0.55)
                if np.hypot(c[0], c[2]) < 1.35:
                    c[[0, 2]] *= 1.35 / max(np.hypot(c[0], c[2]), 1e-6)
                size = rng.uniform(0.22, 0.48)
                if k % 2 == 0:
                    spheres.append([c[0], c[1], c[2], size])
                else:
                    half = rng.uniform(0.18, 0.42, 3)
                    boxes.append(list(c - half) + list(c + half))
        return (np.asarray(spheres, np.float64).reshape(-1, 4),
                np.asarray(boxes, np.float64).reshape(-1, 6))

    def _cast(self, ro, rd, t_wall):
        """Nearest hit among wall exit and interior objects.

        Returns (t, obj_id) with obj_id 0 = walls, 1.. = objects (ordered
        spheres then boxes). t stays in the planar-z ray parameterization.
        """
        t_best = t_wall
        obj = np.zeros(t_wall.shape, np.int32)
        oid = 1
        for cx, cy, cz, r in self.spheres:
            oc = ro - np.array([cx, cy, cz])
            a = (rd * rd).sum(-1)
            b = 2.0 * (rd * oc).sum(-1)
            cq = (oc * oc).sum() - r * r
            disc = b * b - 4 * a * cq
            with np.errstate(invalid="ignore"):
                t_hit = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
            ok = (disc > 0) & (t_hit > 1e-6) & (t_hit < t_best)
            t_best = np.where(ok, t_hit, t_best)
            obj = np.where(ok, oid, obj)
            oid += 1
        for lo_hi in self.boxes:
            lo, hi = lo_hi[:3], lo_hi[3:]
            with np.errstate(divide="ignore", invalid="ignore"):
                ta = (lo - ro) / rd
                tb = (hi - ro) / rd
            t_near = np.maximum(np.minimum(ta, tb).max(-1), 1e-6)
            t_far = np.maximum(ta, tb).min(-1)
            ok = (t_near < t_far) & (t_near < t_best)
            t_best = np.where(ok, t_near, t_best)
            obj = np.where(ok, oid, obj)
            oid += 1
        return t_best, obj

    def _color_field(self, pts, obj_id=None):
        """Procedural 3D texture in [0,1]^3; objects get albedo contrast."""
        f = self.tex_freq
        x, y, z = pts[..., 0] * f, pts[..., 1] * f, pts[..., 2] * f
        r = 0.5 + 0.25 * np.sin(2.1 * x) * np.cos(1.3 * z) + 0.25 * np.sin(3.7 * y)
        g = 0.5 + 0.25 * np.cos(1.7 * x + 2.0 * y) + 0.25 * np.sin(2.9 * z)
        b = 0.5 + 0.25 * np.sin(1.1 * x + 1.9 * z) + 0.25 * np.cos(2.3 * y)
        col = np.stack([r, g, b], -1)
        if self.tex_detail > 0:
            d = self.tex_detail
            col = col + d * np.stack(
                [np.sin(9.7 * x + 3.1 * np.sin(2.9 * y)) * np.cos(8.3 * z),
                 np.sin(11.3 * y + 2.7 * np.cos(3.7 * z)) * np.cos(7.9 * x),
                 np.sin(8.9 * z + 3.3 * np.sin(3.1 * x)) * np.cos(10.1 * y)],
                -1) * 0.5
        if obj_id is not None and (len(self.spheres) or len(self.boxes)):
            # per-object albedo tint: stable hue shifts keyed by object id
            n_obj = len(self.spheres) + len(self.boxes) + 1
            rng = np.random.default_rng(self.seed * 17 + 3)
            palette = 0.55 + 0.45 * rng.uniform(size=(n_obj, 3))
            palette[0] = 1.0  # walls keep the raw field
            col = col * palette[obj_id]
        return np.clip(col, 0.0, 1.0)

    def gt_mesh(self, subdiv=64, sphere_res=48):
        """Analytic ground-truth surface: walls + interior objects.

        Triangulated for reconstruction eval (tools/eval_recon); exact by
        construction, so F-score/depth-L1 against it measure the SLAM +
        meshing stack with no GT uncertainty.
        """
        verts, faces = [], []

        def add_quad_grid(origin, du, dv, n):
            base = sum(len(v) for v in verts)
            g = []
            for a in range(n + 1):
                for b in range(n + 1):
                    g.append(origin + du * (a / n) + dv * (b / n))
            f = []
            for a in range(n):
                for b in range(n):
                    i0 = base + a * (n + 1) + b
                    f.extend([[i0, i0 + 1, i0 + n + 1],
                              [i0 + 1, i0 + n + 2, i0 + n + 1]])
            verts.append(np.asarray(g, np.float64))
            faces.append(np.asarray(f, np.int64))

        def add_box(lo, hi, n=8):
            lo = np.asarray(lo, np.float64)
            hi = np.asarray(hi, np.float64)
            d = hi - lo
            ex = np.array([d[0], 0, 0])
            ey = np.array([0, d[1], 0])
            ez = np.array([0, 0, d[2]])
            add_quad_grid(lo, ey, ez, n)
            add_quad_grid(lo + ex, ey, ez, n)
            add_quad_grid(lo, ex, ez, n)
            add_quad_grid(lo + ey, ex, ez, n)
            add_quad_grid(lo, ex, ey, n)
            add_quad_grid(lo + ez, ex, ey, n)

        add_box(-self.box, self.box, n=subdiv)
        for cx, cy, cz, r in self.spheres:
            base = sum(len(v) for v in verts)
            th = np.linspace(0, np.pi, sphere_res // 2 + 1)
            ph = np.linspace(0, 2 * np.pi, sphere_res + 1)
            T, P = np.meshgrid(th, ph, indexing="ij")
            sv = np.stack([cx + r * np.sin(T) * np.cos(P),
                           cy + r * np.cos(T),
                           cz + r * np.sin(T) * np.sin(P)], -1).reshape(-1, 3)
            nt, nph = T.shape
            f = []
            for a in range(nt - 1):
                for b in range(nph - 1):
                    i0 = base + a * nph + b
                    f.extend([[i0, i0 + nph, i0 + 1],
                              [i0 + 1, i0 + nph, i0 + nph + 1]])
            verts.append(sv)
            faces.append(np.asarray(f, np.int64))
        for lo_hi in self.boxes:
            add_box(lo_hi[:3], lo_hi[3:], n=8)
        v = np.concatenate(verts).astype(np.float32)
        f = np.concatenate(faces).astype(np.int32)
        return v, f

    def _frame_arrays(self, index):
        if index not in self._cache:
            c2w = self.poses[index]
            h, w = self.H, self.W
            jj, ii = np.meshgrid(np.arange(h, dtype=np.float64),
                                 np.arange(w, dtype=np.float64), indexing="ij")
            dirs = np.stack([(ii - self.cx) / self.fx,
                             -(jj - self.cy) / self.fy,
                             -np.ones_like(ii)], -1)
            rd = dirs @ c2w[:3, :3].T
            ro = c2w[:3, 3]
            # ray/axis-aligned-box exit distance (camera inside the box)
            with np.errstate(divide="ignore"):
                t1 = (self.box[None, None] - ro) / rd
                t2 = (-self.box[None, None] - ro) / rd
            t_exit = np.minimum(np.maximum(t1, t2).min(-1), 1e9)
            t_exit, obj_id = self._cast(ro, rd, t_exit)
            pts = ro + rd * t_exit[..., None]
            depth = t_exit  # z-depth == ray parameter since |dir_z|=1? no:
            # the reference convention treats z_vals as the ray parameter with
            # unnormalized dirs; sensor depth is the distance along the ray
            # parameterization, so t_exit is the correct "depth".
            color = self._color_field(pts, obj_id)
            if self.noise > 0:
                rng = np.random.default_rng(self.seed + index)
                depth = depth * (1 + self.noise * rng.standard_normal(depth.shape))
            if self.dropout > 0:
                # sensor holes (TUM/ScanNet-like): depth==0 marks invalid
                rng = np.random.default_rng(self.seed * 7919 + index)
                depth = np.where(rng.uniform(size=depth.shape) < self.dropout,
                                 0.0, depth)
            self._cache[index] = (color.astype(np.float32),
                                  depth.astype(np.float32))
        color, depth = self._cache[index]
        e = self.crop_edge
        if e > 0:
            color, depth = color[e:-e, e:-e], depth[e:-e, e:-e]
        return color, depth


dataset_dict = {
    "replica": Replica,
    "scannet": ScanNet,
    "tumrgbd": TUM_RGBD,
    "synthetic": Synthetic,
}


def get_dataset(cfg, input_folder=None):
    return dataset_dict[cfg["dataset"]](cfg, input_folder)
