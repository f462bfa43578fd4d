"""Plain PyTorch reference of the port's CILQR solve, in any float type.

Written from the upstream C++ semantics (src/cilqr_solver.cpp:85-153 and
:199-713, src/utils.cpp:265-439) as a frozen numpy oracle of them spells
them out one scenario at a time (the repository's
``tests/oracle_cilqr.py``): the kinematic bicycle (rear or gravity center,
with the upstream Jacobian's slip-angle quirk), the tracking and control
costs, exponential barriers on the control, velocity and road-border
constraints and on two discs against each agent's inflated ellipse, the
Riccati backward pass with its failure test, the backtracking line search
(alpha = 1, 1/2, ... while above 1e-6; convergence judged at alpha = 1 and
that trial not adopted; acceptance by the expected-decrease ratio) and the
lambda and status machine.

On top, what the port derives for its kernel and this file works out again
from the same inputs: the reference-line window (``window``: ``W`` rows
from ``w_back`` rows behind the squared distance's first minimum at the
start, clamped at 0 and at the line's end) and the rows each horizon step
searches (``row_limits``: the first ``min(W, round_up_8(w_back + 16 + k *
rows))`` rows of the window at step k, first minimum of the squared
distance).

Rows are batched along a leading axis and follow their own control flow
under masks; a row's values change only while it is still iterating. The
barrier's exponent is not clipped: in float64 it never overflows on these
scenarios. Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

RUNNING, CONVERGED, BACKWARD_FAIL, FORWARD_FAIL, SMALL_STEP = 0, 1, 2, 3, 4
MIN_ALPHA = 1e-6
WINDOW_SLACK = 16  # window rows past the per-step search bound


def alphas() -> tuple:
    out, a = [], 1.0
    while a > MIN_ALPHA:
        out.append(a)
        a *= 0.5
    return tuple(out)


def row_limits(N: int, W: int, w_back: int, rows_per_step: int) -> tuple:
    """Window rows searched at horizon steps 0..N (all W when
    ``rows_per_step`` is 0)."""
    if rows_per_step <= 0:
        return (W,) * (N + 1)
    return tuple(min(W, -(-(w_back + WINDOW_SLACK + k * rows_per_step) // 8) * 8)
                 for k in range(N + 1))


def proj_rows(target_velocity: float, dt: float) -> int:
    """Rows per horizon step that the 0.1 m line advances at 1.1 times the
    target velocity."""
    return int(math.ceil(1.1 * float(target_velocity) * float(dt) / 0.1))


def window(line, x0, W: int, w_back: int):
    """(S, W, 3) window of the (P, 3+) line for starts x0 (S, 4)."""
    P = line.shape[0]
    d2 = (line[None, :, 0] - x0[:, 0:1]) ** 2 + (line[None, :, 1] - x0[:, 1:2]) ** 2
    start = torch.clamp_min(torch.argmin(d2, dim=1) - w_back, 0)
    idx = torch.clamp_max(start[:, None] + torch.arange(W, device=line.device), P - 1)
    return line[:, :3][idx]


class Params(NamedTuple):
    dt: float
    wb: float
    width: float
    length: float
    d_safe: float
    vmax: float
    vmin: float
    amax: float
    amin: float
    stl: float
    w_pos: float
    w_vel: float
    w_yaw: float
    w_acc: float
    w_stl: float
    sq1: float
    sq2: float
    oq1: float
    oq2: float
    init_lamb: float
    lamb_decay: float
    lamb_amplify: float
    max_lamb: float
    conv: float
    accept: float
    max_iter: int
    N: int
    gravity: bool
    road_hi: float
    road_lo: float
    v_ref: float

    @classmethod
    def of(cls, sc: dict) -> "Params":
        """From a configuration's scenario (the upstream yaml's layout)."""
        v, q, it = sc["vehicle"], sc["lqr"], sc["iteration"]
        if str(q.get("slove_type", q.get("solve_type"))) != "barrier":
            raise NotImplementedError("the reference has the exponential barrier only")
        borders = [float(b) for b in sc["laneline"]["border"]]
        f = float
        return cls(dt=f(sc["delta_t"]), wb=f(v["wheelbase"]), width=f(v["width"]),
                   length=f(v["length"]), d_safe=f(v["d_safe"]), vmax=f(v["velo_max"]),
                   vmin=f(v["velo_min"]), amax=f(v["acc_max"]), amin=f(v["acc_min"]),
                   stl=f(v["stl_lim"]), w_pos=f(q["w_pos"]), w_vel=f(q["w_vel"]),
                   w_yaw=f(q["w_yaw"]), w_acc=f(q["w_acc"]), w_stl=f(q["w_stl"]),
                   sq1=f(q["state_exp_q1"]), sq2=f(q["state_exp_q2"]),
                   oq1=f(q["obstacle_exp_q1"]), oq2=f(q["obstacle_exp_q2"]),
                   init_lamb=f(it["init_lamb"]), lamb_decay=f(it["lamb_decay"]),
                   lamb_amplify=f(it["lamb_amplify"]), max_lamb=f(it["max_lamb"]),
                   conv=f(it["convergence_threshold"]), accept=f(it["accept_step_threshold"]),
                   max_iter=int(it["max_iter"]), N=int(q["N"]),
                   gravity=v.get("reference_point", "gravity_center") != "rear_center",
                   road_hi=max(borders), road_lo=min(borders),
                   v_ref=f(v["target_velocity"]))


class Solution(NamedTuple):
    u: torch.Tensor  # (S, N, 2)
    x: torch.Tensor  # (S, N+1, 4)
    iters: torch.Tensor  # (S,) iterations run
    status: torch.Tensor  # (S,)
    cost: torch.Tensor  # (S,) final cost


class Reference:
    """The solve of a configuration's ``Params`` in ``dtype``."""

    def __init__(self, p: Params, dtype=torch.float64):
        self.p, self.dtype = p, dtype

    # -- dynamics ---------------------------------------------------------
    def propagate(self, x, u):
        p = self.p
        px, py, v, yaw = x.unbind(-1)
        acc, stl = u.unbind(-1)
        if p.gravity:
            beta = torch.atan(torch.tan(stl) / 2)
            return torch.stack([px + v * torch.cos(beta + yaw) * p.dt,
                                py + v * torch.sin(beta + yaw) * p.dt, v + acc * p.dt,
                                yaw + 2 * v * torch.sin(beta) * p.dt / p.wb], -1)
        return torch.stack([px + v * torch.cos(yaw) * p.dt, py + v * torch.sin(yaw) * p.dt,
                            v + acc * p.dt, yaw + v * torch.tan(stl) * p.dt / p.wb], -1)

    def rollout(self, x0, u):
        xs = [x0]
        for k in range(u.shape[-2]):
            xs.append(self.propagate(xs[-1], u[..., k, :]))
        return torch.stack(xs, -2)

    def jacobians(self, x, u):
        """A (S, N, 4, 4), B (S, N, 4, 2) along x[:, :N], u."""
        p = self.p
        v, yaw, stl = x[..., 2], x[..., 3], u[..., 1]
        S, N = v.shape
        A = torch.eye(4, dtype=x.dtype, device=x.device).repeat(S, N, 1, 1)
        B = x.new_zeros((S, N, 4, 2))
        B[..., 2, 0] = p.dt
        if p.gravity:
            # the upstream Jacobian's slip angle is atan(tan(stl / 2))
            # (src/utils.cpp:292), the dynamics' atan(tan(stl) / 2);
            # the factor is the dynamics' d beta / d stl
            beta = torch.atan(torch.tan(stl / 2))
            t2 = torch.tan(stl) ** 2
            dbds = 0.5 * (1 + t2) / (1 + 0.25 * t2)
            c, s = torch.cos(beta + yaw), torch.sin(beta + yaw)
            A[..., 0, 2], A[..., 0, 3] = c * p.dt, -v * s * p.dt
            A[..., 1, 2], A[..., 1, 3] = s * p.dt, v * c * p.dt
            A[..., 3, 2] = 2 * torch.sin(beta) * p.dt / p.wb
            B[..., 0, 1] = -v * s * p.dt * dbds
            B[..., 1, 1] = v * c * p.dt * dbds
            B[..., 3, 1] = (2 * v * p.dt / p.wb) * torch.cos(beta) * dbds
        else:
            c, s = torch.cos(yaw), torch.sin(yaw)
            A[..., 0, 2], A[..., 0, 3] = c * p.dt, -v * s * p.dt
            A[..., 1, 2], A[..., 1, 3] = s * p.dt, v * c * p.dt
            A[..., 3, 2] = torch.tan(stl) * p.dt / p.wb
            B[..., 3, 1] = (v * p.dt / p.wb) / torch.cos(stl) ** 2
        return A, B

    # -- cost -------------------------------------------------------------
    def _discs(self, x):
        """Front and rear disc centres (..., 2) and their Jacobians (..., 4, 2)."""
        p = self.p
        yaw = x[..., 3]
        c, s = torch.cos(yaw), torch.sin(yaw)
        z = torch.zeros_like(yaw)
        o = torch.ones_like(yaw)
        lead = 0.5 * p.wb if p.gravity else p.wb
        front = x[..., :2] + lead * torch.stack([c, s], -1)
        rear = x[..., :2] - 0.5 * p.wb * torch.stack([c, s], -1) if p.gravity else x[..., :2]
        back = 0.5 * p.wb if p.gravity else 0.0

        def jac(a3, b3):
            return torch.stack([torch.stack([o, z], -1), torch.stack([z, o], -1),
                                torch.stack([z, z], -1), torch.stack([a3, b3], -1)], -2)

        return front, rear, jac(-lead * s, lead * c), jac(back * s, -back * c)

    def _ellipse(self, pnt, ob):
        """Margin 1 - (x'/a)^2 - (y'/b)^2 of points (..., 2) in the frames of
        agents (..., 3), and its gradient in the point (..., 2)."""
        p = self.p
        r = 0.5 * p.width
        a = 0.5 * p.length + 6 * p.d_safe + r
        b = 0.5 * p.width + p.d_safe + r
        dx, dy = pnt[..., 0] - ob[..., 0], pnt[..., 1] - ob[..., 1]
        c, s = torch.cos(ob[..., 2]), torch.sin(ob[..., 2])
        xs, ys = c * dx + s * dy, -s * dx + c * dy
        gx, gy = -2 * xs / a**2, -2 * ys / b**2
        return 1 - (xs**2 / a**2 + ys**2 / b**2), torch.stack([c * gx - s * gy,
                                                                 s * gx + c * gy], -1)

    def _terms(self, u, x, win, limits, obs, grads: bool):
        """The tracking target, the constraint values (S, N, C) and, with
        ``grads``, their gradients in u (S, N, 4, 2) and in x (S, N, C-4, 4)."""
        p = self.p
        S, N1 = x.shape[0], x.shape[1]
        score = ((x[:, :, None, 0] - win[:, None, :, 0]) ** 2
                 + (x[:, :, None, 1] - win[:, None, :, 1]) ** 2)  # (S, N+1, W)
        rows = torch.arange(win.shape[1], device=x.device)
        score = score.masked_fill(rows >= limits[:, None], float("inf"))
        ref = torch.gather(win, 1, torch.argmin(score, -1)[..., None].expand(-1, -1, 3))
        xk, rk, uk = x[:, 1:], ref[:, 1:], u
        ddx, ddy = xk[..., 0] - rk[..., 0], xk[..., 1] - rk[..., 1]
        d_sign = ddy * torch.cos(rk[..., 2]) - ddx * torch.sin(rk[..., 2])
        sgn = torch.where(d_sign < 0, -1.0, 1.0).to(x.dtype)
        h = torch.hypot(ddx, ddy)
        cur_d = sgn * h
        cols = [uk[..., 0] - p.amax, p.amin - uk[..., 0], uk[..., 1] - p.stl,
                -p.stl - uk[..., 1], xk[..., 2] - p.vmax, p.vmin - xk[..., 2],
                cur_d - (p.road_hi - p.width / 2), (p.road_lo + p.width / 2) - cur_d]
        front, rear, jf, jr = self._discs(xk)
        ob = obs[:, :, 1:]  # (S, M, N, 3)
        mf, gf = self._ellipse(front[:, None], ob)
        mr, gr = self._ellipse(rear[:, None], ob)
        M = ob.shape[1]
        for j in range(M):
            cols += [mf[:, j], mr[:, j]]
        c = torch.stack(cols, -1)
        target = torch.stack([ref[..., 0], ref[..., 1], torch.full_like(ref[..., 0], p.v_ref),
                              ref[..., 2]], -1)
        if not grads:
            return target, c, None, None
        eye2 = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]], dtype=x.dtype,
                            device=x.device)
        g_u = eye2.expand(S, N1 - 1, 4, 2)
        pos = h > 0
        safe = torch.where(pos, h, torch.ones_like(h))
        z = torch.zeros_like(h)
        up = torch.stack([sgn * torch.where(pos, ddx / safe, z),
                          sgn * torch.where(pos, ddy / safe, z), z, z], -1)
        vel = torch.stack([z, z, torch.ones_like(h), z], -1)
        gx = [vel, -vel, up, -up]
        for j in range(M):
            gx += [(jf @ gf[:, j][..., None])[..., 0], (jr @ gr[:, j][..., None])[..., 0]]
        return target, c, g_u, torch.stack(gx, -2)

    def _barrier(self, c):
        p = self.p
        C = c.shape[-1]
        q1 = torch.tensor([p.sq1] * 8 + [p.oq1] * (C - 8), dtype=c.dtype, device=c.device)
        q2 = torch.tensor([p.sq2] * 8 + [p.oq2] * (C - 8), dtype=c.dtype, device=c.device)
        b = q1 * torch.exp(q2 * c)
        return b, q2

    def _diag(self, like):
        p = self.p
        wq = torch.tensor([p.w_pos, p.w_pos, p.w_vel, p.w_yaw], dtype=like.dtype,
                          device=like.device)
        wr = torch.tensor([p.w_acc, p.w_stl], dtype=like.dtype, device=like.device)
        return wq, wr

    def cost(self, u, x, win, limits, obs):
        """(S,) total cost."""
        target, c, _, _ = self._terms(u, x, win, limits, obs, grads=False)
        wq, wr = self._diag(x)
        dx = x - target
        b, _ = self._barrier(c)
        return (dx * dx * wq).sum((1, 2)) + (u * u * wr).sum((1, 2)) + b.sum((1, 2))

    def derivatives(self, u, x, win, limits, obs):
        """(J, l_x (S,N+1,4), l_u (S,N,2), l_xx (S,N+1,4,4), l_uu (S,N,2,2))."""
        target, c, g_u, g_x = self._terms(u, x, win, limits, obs, grads=True)
        wq, wr = self._diag(x)
        dx = x - target
        b, q2 = self._barrier(c)
        J = (dx * dx * wq).sum((1, 2)) + (u * u * wr).sum((1, 2)) + b.sum((1, 2))
        gam, eta = q2 * b, q2 * q2 * b
        S, N = u.shape[0], u.shape[1]
        l_u = 2 * u * wr + torch.einsum("snc,snci->sni", gam[..., :4], g_u)
        l_uu = (torch.diag_embed(2 * wr).expand(S, N, 2, 2)
                + torch.einsum("snc,snci,sncj->snij", eta[..., :4], g_u, g_u))
        l_x = 2 * dx * wq
        l_x[:, 1:] += torch.einsum("snc,snci->sni", gam[..., 4:], g_x)
        l_xx = torch.diag_embed(2 * wq).expand(S, N + 1, 4, 4).clone()
        l_xx[:, 1:] += torch.einsum("snc,snci,sncj->snij", eta[..., 4:], g_x, g_x)
        return J, l_x, l_u, l_xx, l_uu

    # -- iLQR ---------------------------------------------------------------
    def backward(self, A, B, l_x, l_u, l_xx, l_uu, lamb):
        """Gains d (S,N,2), K (S,N,2,4), expected decrease dV1, dV2 (S,) and
        each row's failure flag (a step whose Q_uu is not positive
        definite)."""
        S, N = l_u.shape[0], l_u.shape[1]
        d = l_u.new_zeros((S, N, 2))
        K = l_u.new_zeros((S, N, 2, 4))
        dV1, dV2 = l_u.new_zeros(S), l_u.new_zeros(S)
        fail = torch.zeros(S, dtype=torch.bool, device=l_u.device)
        V_x, V_xx = l_x[:, N], l_xx[:, N]
        eye = torch.eye(2, dtype=l_u.dtype, device=l_u.device)
        for i in range(N - 1, -1, -1):
            At, Bt = A[:, i].transpose(-1, -2), B[:, i].transpose(-1, -2)
            Q_x = l_x[:, i] + (At @ V_x[..., None])[..., 0]
            Q_u = l_u[:, i] + (Bt @ V_x[..., None])[..., 0]
            Q_xx = l_xx[:, i] + At @ V_xx @ A[:, i]
            Q_uu = l_uu[:, i] + Bt @ V_xx @ B[:, i] + lamb[:, None, None] * eye
            Q_ux = Bt @ V_xx @ A[:, i]
            a, b_, c, e = Q_uu[:, 0, 0], Q_uu[:, 0, 1], Q_uu[:, 1, 0], Q_uu[:, 1, 1]
            det = a * e - b_ * c
            fail = fail | (a <= 0) | (det <= 0)
            inv = torch.stack([torch.stack([e, -b_], -1), torch.stack([-c, a], -1)], -2) \
                / det[:, None, None]
            di = -(inv @ Q_u[..., None])[..., 0]
            Ki = -inv @ Q_ux
            d[:, i], K[:, i] = di, Ki
            Kt = Ki.transpose(-1, -2)
            V_x = (Q_x + (Kt @ (Q_uu @ di[..., None]))[..., 0] + (Kt @ Q_u[..., None])[..., 0]
                   + (Q_ux.transpose(-1, -2) @ di[..., None])[..., 0])
            V_xx = Q_xx + Kt @ Q_uu @ Ki + Kt @ Q_ux + Q_ux.transpose(-1, -2) @ Ki
            dV1 = dV1 + 0.5 * (di * (Q_uu @ di[..., None])[..., 0]).sum(-1)
            dV2 = dV2 + (di * Q_u).sum(-1)
        return d, K, dV1, dV2, fail

    def trials(self, u, x, d, K, al):
        """Trial rollouts of the alphas ``al`` for every row: (S*A, N, 2),
        (S*A, N+1, 4), rows of a trial together."""
        A = len(al)
        alpha = torch.tensor(al, dtype=u.dtype, device=u.device).repeat(u.shape[0])[:, None]

        def rep(t):
            return t.repeat_interleave(A, 0)

        u, x, d, K = rep(u), rep(x), rep(d), rep(K)
        nx = [x[:, 0]]
        nu = []
        for i in range(u.shape[1]):
            ui = u[:, i] + (K[:, i] @ (nx[i] - x[:, i])[..., None])[..., 0] + alpha * d[:, i]
            nu.append(ui)
            nx.append(self.propagate(nx[i], ui))
        return torch.stack(nu, 1), torch.stack(nx, 1)

    def solve(self, x0, u0, win, limits, obs, chunk: int = 4) -> Solution:
        """Solve rows x0 (S, 4) from controls u0 (S, N, 2) against windows
        win (S, W, 3) searched by ``limits`` (N+1,) and agents' predictions
        obs (S, M, N+1, 3)."""
        p = self.p
        x0, u, win, obs = (t.to(self.dtype) for t in (x0, u0, win, obs))
        limits = torch.as_tensor(limits, device=x0.device)
        S = x0.shape[0]
        dev = x0.device
        x = self.rollout(x0, u)
        lamb = torch.full((S,), p.init_lamb, dtype=self.dtype, device=dev)
        status = torch.zeros(S, dtype=torch.int64, device=dev)
        iters = torch.zeros(S, dtype=torch.int64, device=dev)
        done = torch.zeros(S, dtype=torch.bool, device=dev)
        al_all = alphas()
        for _ in range(p.max_iter):
            active = ~done
            if not bool(active.any()):
                break
            J, l_x, l_u, l_xx, l_uu = self.derivatives(u, x, win, limits, obs)
            A, B = self.jacobians(x[:, :-1], u)
            d, K, dV1, dV2, fail = self.backward(A, B, l_x, l_u, l_xx, l_uu, lamb)
            decided = ~active | fail
            acc = torch.zeros_like(done)
            conv = torch.zeros_like(done)
            small = torch.zeros_like(done)
            new_u, new_x = u, x
            for t0 in range(0, len(al_all), chunk):
                if bool(decided.all()):
                    break
                al = al_all[t0:t0 + chunk]
                tu, tx = self.trials(u, x, d, K, al)
                rep = len(al)
                tJ = self.cost(tu, tx, win.repeat_interleave(rep, 0), limits,
                               obs.repeat_interleave(rep, 0)).view(S, rep)
                tu, tx = tu.view(S, rep, *u.shape[1:]), tx.view(S, rep, *x.shape[1:])
                for a, alpha in enumerate(al):
                    decay = J - tJ[:, a]
                    conv_now = ~decided & (decay.abs() < p.conv) if t0 + a == 0 \
                        else torch.zeros_like(done)
                    approx = -(alpha * alpha * dV1 + alpha * dV2)
                    ratio = torch.where(approx != 0, decay / approx,
                                        torch.full_like(decay, float("inf")))
                    acc_now = ~decided & ~conv_now & (decay > 0) & (
                        (approx < 0) | (ratio > p.accept))
                    new_u = torch.where(acc_now[:, None, None], tu[:, a], new_u)
                    new_x = torch.where(acc_now[:, None, None], tx[:, a], new_x)
                    if t0 + a > 0:
                        small = small | acc_now
                    acc, conv = acc | acc_now, conv | conv_now
                    decided = decided | acc_now | conv_now
            search = active & ~fail
            accepted, conv_now = search & acc, search & conv
            exhausted = search & ~acc & ~conv
            u = torch.where(accepted[:, None, None], new_u, u)
            x = torch.where(accepted[:, None, None], new_x, x)
            new_status = torch.full_like(status, RUNNING)
            new_status[accepted & small] = SMALL_STEP
            new_status[exhausted] = FORWARD_FAIL
            new_status[conv_now] = CONVERGED
            new_status[active & fail] = BACKWARD_FAIL
            status = torch.where(active, new_status, status)
            failed = active & (fail | exhausted)
            lamb = torch.where(failed, torch.clamp_min(lamb * p.lamb_amplify, p.lamb_amplify),
                               torch.where(active & (status == RUNNING), lamb * p.lamb_decay,
                                           lamb))
            done = done | conv_now | (active & (lamb > p.max_lamb))
            iters = iters + active.to(torch.int64)
        return Solution(u, x, iters, status, self.cost(u, x, win, limits, obs))
