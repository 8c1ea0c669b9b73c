"""Gravity-aware absolute pose estimation (a downstream application).

Port of geocalib_tpu/pose_estimation.py, numpy on the host as there: the
2-point minimal solver with known gravity (rotating both frames gravity-up
makes a correspondence linear in (cos θ, sin θ, t)), RANSAC over minimal
samples with reprojection-error scoring, Gauss-Newton refinement of
(rotation, t) over the inliers with an optional gravity-alignment residual,
DLT PnP (≥ 6 points) as the fallback without gravity, and quaternions.
``AbsolutePoseEstimator`` takes the camera's gravity and its uncertainty
from the port's ``GeoCalib.calibrate`` (on the card by default) and reads
them back to numpy.

Conventions: world-to-camera pose x_cam = R @ X_world + t; gravity in the
camera frame as ``Gravity.vec3d`` gives it ((0, -1, 0) for an upright
camera); world gravity defaults to (0, 0, -1) ("z up").
"""

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

Array = np.ndarray


# --------------------------------------------------------------------- #
# small rotation utilities
# --------------------------------------------------------------------- #


def rotation_aligning(a: Array, b: Array) -> Array:
    """Rotation matrix R with R @ a = b (unit vectors; Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(a @ b)
    if np.linalg.norm(v) < 1e-12:
        if c > 0:
            return np.eye(3)
        # antiparallel: rotate π about any axis ⊥ a
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis /= np.linalg.norm(axis)
        return 2.0 * np.outer(axis, axis) - np.eye(3)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx / (1.0 + c)


def rot_z(theta: float) -> Array:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def quat_from_matrix(R: Array) -> Array:
    """(w, x, y, z) quaternion from a rotation matrix."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


# --------------------------------------------------------------------- #
# camera projection (colmap-style dict)
# --------------------------------------------------------------------- #


def _camera_kf(camera_dict: Dict) -> Tuple[Array, Array, float]:
    """(fx, fy), (cx, cy), k1 from a colmap camera dict."""
    model = camera_dict.get("model", "PINHOLE")
    p = np.asarray(camera_dict["params"], np.float64)
    if model in ("PINHOLE",):
        return p[0:2], p[2:4], 0.0
    if model in ("SIMPLE_PINHOLE",):
        return np.array([p[0], p[0]]), p[1:3], 0.0
    if model in ("SIMPLE_RADIAL",):
        return np.array([p[0], p[0]]), p[1:3], float(p[3])
    raise ValueError(f"unsupported camera model {model!r}")


def project(p3d_cam: Array, camera_dict: Dict) -> Tuple[Array, Array]:
    """Project camera-frame points to pixels; returns (p2d, in_front)."""
    f, c, k1 = _camera_kf(camera_dict)
    z = p3d_cam[:, 2]
    valid = z > 1e-6
    uv = p3d_cam[:, :2] / np.maximum(z, 1e-6)[:, None]
    if k1 != 0.0:
        r2 = (uv**2).sum(-1, keepdims=True)
        uv = uv * (1.0 + k1 * r2)
    return uv * f + c, valid


def bearings(p2d: Array, camera_dict: Dict) -> Array:
    """Unit bearing vectors for pixel observations (undistorted)."""
    f, c, k1 = _camera_kf(camera_dict)
    uv = (np.asarray(p2d, np.float64) - c) / f
    if k1 != 0.0:
        # Drap-Lefèvre first-order inverse (same family as geometry/camera.py)
        r2 = (uv**2).sum(-1, keepdims=True)
        uv = uv * (1.0 - k1 * r2)
    b = np.concatenate([uv, np.ones((len(uv), 1))], axis=-1)
    return b / np.linalg.norm(b, axis=-1, keepdims=True)


# --------------------------------------------------------------------- #
# solvers
# --------------------------------------------------------------------- #


def solve_gravity_minimal(b_up: Array, X_up: Array):
    """Yaw + translation candidates from 2 gravity-aligned correspondences.

    In the gravity-aligned frames, cross(b_i, R_z(θ) X_i + t) = 0 is linear
    in u = [cos θ, sin θ, t]. Two points give a rank-4 system over the 5
    unknowns — the solution line u(α) = u_p + α·v (v the nullspace vector)
    is intersected with the circle constraint cos² + sin² = 1, a quadratic
    in α with up to two roots (the two-fold yaw ambiguity of the minimal
    problem). Returns a list of (theta, t_up) candidates.
    """
    rows_A, rows_b = [], []
    for b, X in zip(b_up, X_up):
        Bx = np.array([[0, -b[2], b[1]], [b[2], 0, -b[0]], [-b[1], b[0], 0]])
        M = np.array([[X[0], -X[1]], [X[1], X[0]], [0.0, 0.0]])
        rows_A.append(np.concatenate([Bx @ M, Bx], axis=1))  # (3, 5)
        rows_b.append(-Bx @ np.array([0.0, 0.0, X[2]]))
    A = np.concatenate(rows_A, axis=0)
    rhs = np.concatenate(rows_b, axis=0)

    U, S, Vt = np.linalg.svd(A, full_matrices=False)
    if S[0] < 1e-12:
        return []
    # pseudo-inverse particular solution + nullspace direction
    inv_s = np.where(S > 1e-9 * S[0], 1.0 / np.maximum(S, 1e-300), 0.0)
    u_p = Vt.T @ (inv_s * (U.T @ rhs))
    v = Vt[-1]

    # (c_p + α v_c)² + (s_p + α v_s)² = 1
    cp, sp = u_p[0], u_p[1]
    vc, vs = v[0], v[1]
    a = vc * vc + vs * vs
    b_ = 2.0 * (cp * vc + sp * vs)
    c_ = cp * cp + sp * sp - 1.0
    cands = []
    if a < 1e-14:
        # overdetermined (≥3 pts, empty nullspace): normalize lstsq solution
        n = np.hypot(cp, sp)
        if n < 1e-9:
            return []
        alphas = [0.0]
        u_all = [u_p]
    else:
        disc = b_ * b_ - 4.0 * a * c_
        if disc < 0:
            return []
        alphas = [(-b_ + np.sqrt(disc)) / (2 * a), (-b_ - np.sqrt(disc)) / (2 * a)]
        u_all = [u_p + al * v for al in alphas]
    for u in u_all:
        n = np.hypot(u[0], u[1])
        if n < 1e-9:
            continue
        cands.append((float(np.arctan2(u[1] / n, u[0] / n)), u[2:5]))
    return cands


def solve_pnp_dlt(b: Array, X: Array) -> Optional[Tuple[Array, Array]]:
    """Direct linear PnP from ≥6 bearing-point pairs (no gravity)."""
    n = len(b)
    if n < 6:
        return None
    A = np.zeros((3 * n, 12))
    for i, (bi, Xi) in enumerate(zip(b, X)):
        Bx = np.array([[0, -bi[2], bi[1]], [bi[2], 0, -bi[0]], [-bi[1], bi[0], 0]])
        Xh = np.concatenate([Xi, [1.0]])
        A[3 * i : 3 * i + 3] = np.kron(Bx, Xh).reshape(3, 12)
    _, _, Vt = np.linalg.svd(A)
    P = Vt[-1].reshape(3, 4)
    R_raw, t_raw = P[:, :3], P[:, 3]
    # project to SO(3), fix scale/sign
    U, S, Vt2 = np.linalg.svd(R_raw)
    sign = np.sign(np.linalg.det(U @ Vt2))
    R = U @ np.diag([1.0, 1.0, sign]) @ Vt2
    scale = np.mean(S[:2]) * sign if sign != 0 else np.mean(S)
    t = t_raw / max(abs(np.mean(S)), 1e-12) * np.sign(np.mean(S)) if scale == 0 else t_raw / scale
    # ensure points land in front of the camera
    if np.median((R @ X.T).T[:, 2] + t[2]) < 0:
        return None
    return R, t


def _reproj_errors(R: Array, t: Array, p2d: Array, p3d: Array, camera_dict: Dict) -> Array:
    cam_pts = (R @ p3d.T).T + t
    proj, valid = project(cam_pts, camera_dict)
    err = np.linalg.norm(proj - p2d, axis=-1)
    return np.where(valid, err, np.inf)


def refine_pose_gravity(
    R0: Array,
    t0: Array,
    p2d: Array,
    p3d: Array,
    camera_dict: Dict,
    inliers: Array,
    gravity_cam: Optional[Array] = None,
    gravity_world: Optional[Array] = None,
    gravity_weight: float = 0.0,
    iters: int = 10,
) -> Tuple[Array, Array]:
    """Gauss-Newton on (so(3) delta, t) minimizing the reprojection error
    plus an optional gravity-alignment term weighted by gravity_weight."""
    R, t = R0.copy(), t0.copy()
    sel = np.where(inliers)[0]
    if len(sel) < 3:
        return R, t
    P2, P3 = p2d[sel], p3d[sel]
    f, _, _ = _camera_kf(camera_dict)

    def residuals(R, t):
        cam = (R @ P3.T).T + t
        proj, _ = project(cam, camera_dict)
        r = (proj - P2).ravel()
        if gravity_weight > 0 and gravity_cam is not None:
            g_pred = R @ gravity_world
            r = np.concatenate([r, np.sqrt(gravity_weight) * (g_pred - gravity_cam)])
        return r

    def skew(v):
        return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])

    for _ in range(iters):
        r = residuals(R, t)
        # numeric Jacobian over the 6-dim tangent (cheap: tiny problems)
        J = np.zeros((len(r), 6))
        eps = 1e-6
        for k in range(3):
            w = np.zeros(3)
            w[k] = eps
            dR = np.eye(3) + skew(w)
            J[:, k] = (residuals(dR @ R, t) - r) / eps
            dt = np.zeros(3)
            dt[k] = eps
            J[:, 3 + k] = (residuals(R, t + dt) - r) / eps
        H = J.T @ J + 1e-9 * np.eye(6)
        delta = np.linalg.solve(H, -J.T @ r)
        R = (np.eye(3) + skew(delta[:3])) @ R
        # re-orthonormalize
        U, _, Vt = np.linalg.svd(R)
        R = U @ Vt
        t = t + delta[3:]
        if np.linalg.norm(delta) < 1e-10:
            break
    return R, t


def estimate_absolute_pose_gravity(
    p2d: Array,
    p3d: Array,
    camera_dict: Dict,
    gravity_cam: Array,
    gravity_world: Array = (0.0, 0.0, -1.0),
    max_reproj_error: float = 48.0,
    max_iterations: int = 1000,
    seed: int = 0,
) -> Dict:
    """RANSAC with the 2-point gravity-aligned minimal solver."""
    p2d = np.asarray(p2d, np.float64)
    p3d = np.asarray(p3d, np.float64)
    g_c = np.asarray(gravity_cam, np.float64)
    g_w = np.asarray(gravity_world, np.float64)
    n = len(p2d)
    if n < 2:
        return {"success": False}

    R_c = rotation_aligning(g_c, np.array([0.0, 0.0, 1.0]))
    R_w = rotation_aligning(g_w, np.array([0.0, 0.0, 1.0]))
    b_up = (R_c @ bearings(p2d, camera_dict).T).T
    X_up = (R_w @ p3d.T).T

    rng = np.random.default_rng(seed)
    best = {"success": False, "num_inliers": 0}
    done = False
    for _ in range(max_iterations):
        if done:
            break
        idx = rng.choice(n, size=2, replace=False)
        for theta, t_up in solve_gravity_minimal(b_up[idx], X_up[idx]):
            R = R_c.T @ rot_z(theta) @ R_w
            t = R_c.T @ t_up
            err = _reproj_errors(R, t, p2d, p3d, camera_dict)
            inl = err < max_reproj_error
            k = int(inl.sum())
            if k > best["num_inliers"]:
                best = {
                    "success": True,
                    "R": R,
                    "tvec": t,
                    "inliers": inl,
                    "num_inliers": k,
                }
                if k > 0.9 * n:
                    done = True
                    break
    if best["success"]:
        best["qvec"] = quat_from_matrix(best["R"])
    return best


def estimate_absolute_pose(
    p2d: Array,
    p3d: Array,
    camera_dict: Dict,
    max_reproj_error: float = 48.0,
    max_iterations: int = 500,
    seed: int = 0,
) -> Dict:
    """RANSAC with the 6-point DLT solver (no gravity prior)."""
    p2d = np.asarray(p2d, np.float64)
    p3d = np.asarray(p3d, np.float64)
    n = len(p2d)
    if n < 6:
        return {"success": False}
    b = bearings(p2d, camera_dict)
    rng = np.random.default_rng(seed)
    best = {"success": False, "num_inliers": 0}
    for _ in range(max_iterations):
        idx = rng.choice(n, size=6, replace=False)
        sol = solve_pnp_dlt(b[idx], p3d[idx])
        if sol is None:
            continue
        R, t = sol
        err = _reproj_errors(R, t, p2d, p3d, camera_dict)
        inl = err < max_reproj_error
        k = int(inl.sum())
        if k > best["num_inliers"]:
            best = {"success": True, "R": R, "tvec": t, "inliers": inl, "num_inliers": k}
            if k > 0.9 * n:
                break
    if best["success"]:
        best["qvec"] = quat_from_matrix(best["R"])
    return best


# --------------------------------------------------------------------- #
# the application driver
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class PoseOpts:
    ransac: str = "gravity_2pt"  # "gravity_2pt" | "pnp"
    refinement: str = "gauss_newton_gravity"  # "gauss_newton[_gravity]" | "none"
    gravity_weight: float = 50_000.0
    max_reproj_error: float = 48.0
    max_uncertainty: float = 10.0 / 180.0 * np.pi  # radians
    gravity_world: Tuple[float, float, float] = (0.0, 0.0, -1.0)


def _numpy(x) -> Array:
    """A tensor (on any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class AbsolutePoseEstimator:
    """Gravity-aware localization: calibrate() supplies the gravity prior.

    Per-query calibration (with the focal prior from the known camera) is
    cached by path; RANSAC uses the estimated gravity when its uncertainty is
    small enough, and the refinement adds a weighted gravity-alignment
    residual. The default calibrator is the port's ``GeoCalib(weights)``, on
    the card; pass ``calibrator=GeoCalib(weights, device="cpu")`` for the CPU.
    """

    def __init__(self, opts: Optional[PoseOpts] = None, calibrator=None, weights=None):
        self.opts = opts or PoseOpts()
        if calibrator is None:
            from geocalib_tpu_torch.extractor import GeoCalib

            calibrator = GeoCalib(weights=weights)
        self.calib_model = calibrator
        self.cache: Dict[str, Dict] = {}

    def calibrate(self, query, focal: Optional[float] = None) -> Dict:
        key = query if isinstance(query, str) else None
        if key is not None and key in self.cache:
            return self.cache[key]
        image = query
        if isinstance(query, str):
            from geocalib_tpu_torch.utils.image import load_image

            image = load_image(query)
        priors = {"focal": focal} if focal else None
        out = self.calib_model.calibrate(image, priors=priors)
        calib = {
            "gravity_vec": _numpy(out["gravity"].vec3d).reshape(3),
            "gravity_uncertainty": float(_numpy(out["gravity_uncertainty"]).reshape(())),
        }
        if key is not None:
            self.cache[key] = calib
        return calib

    def __call__(self, query, p2d: Array, p3d: Array, camera_dict: Dict) -> Tuple[Dict, Dict]:
        f, _, _ = _camera_kf(camera_dict)
        calib = self.calibrate(query, focal=float(np.mean(f)))
        g_c, g_u = calib["gravity_vec"], calib["gravity_uncertainty"]
        use_gravity = (
            self.opts.ransac == "gravity_2pt" and g_u <= self.opts.max_uncertainty
        )

        if use_gravity:
            ret = estimate_absolute_pose_gravity(
                p2d,
                p3d,
                camera_dict,
                g_c,
                np.asarray(self.opts.gravity_world),
                max_reproj_error=self.opts.max_reproj_error,
            )
        else:
            ret = estimate_absolute_pose(
                p2d, p3d, camera_dict, max_reproj_error=self.opts.max_reproj_error
            )
        if not ret.get("success"):
            return ret, calib

        if self.opts.refinement != "none":
            with_gravity = (
                self.opts.refinement.endswith("_gravity")
                and g_u <= self.opts.max_uncertainty
            )
            R, t = refine_pose_gravity(
                ret["R"],
                ret["tvec"],
                np.asarray(p2d, np.float64),
                np.asarray(p3d, np.float64),
                camera_dict,
                ret["inliers"],
                gravity_cam=g_c if with_gravity else None,
                gravity_world=np.asarray(self.opts.gravity_world),
                gravity_weight=self.opts.gravity_weight if with_gravity else 0.0,
            )
            err = _reproj_errors(R, t, np.asarray(p2d), np.asarray(p3d), camera_dict)
            ret |= {
                "R": R,
                "tvec": t,
                "qvec": quat_from_matrix(R),
                "inliers": err < self.opts.max_reproj_error,
            }
            ret["num_inliers"] = int(ret["inliers"].sum())
        ret["camera_dict"] = camera_dict
        return ret, calib
