"""State-space and recurrent blocks: Mamba (Hymba's SSM heads), mLSTM and
sLSTM (xLSTM), counterpart of ``repro.models.ssm``, in plain PyTorch (the
JAX package has no kernel here).

Each has a full-sequence form for prefill (chunkwise for mamba and mLSTM,
a step loop for sLSTM, whose hidden state feeds back into its gates) and
a single-step form for decode on a carried state.  States are f32 and
O(heads · state) in size, whatever the sequence length.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec

f32 = torch.float32


def _pad_seq(a: torch.Tensor, pad: int, fill: float = 0.0) -> torch.Tensor:
    """Pad the sequence axis (1) of ``a`` with ``pad`` entries of ``fill``."""
    if not pad:
        return a
    return torch.cat([a, a.new_full((a.shape[0], pad) + a.shape[2:], fill)],
                     dim=1)


def _chunks(a: torch.Tensor, c: int):
    """(B, S, ...) with S a multiple of c → the S/c chunks (B, c, ...)."""
    return a.reshape(a.shape[0], -1, c, *a.shape[2:]).unbind(1)


# ------------------------------------------------------------------ mamba --


def mamba_specs(cfg: ModelConfig) -> Dict:
    """Selective SSM (Mamba-style, diagonal A) with H heads of size hd."""
    D, H, hd, N = cfg.d_model, cfg.num_heads, cfg.hd, cfg.ssm_state
    inner = H * hd
    return dict(
        wx=ParamSpec((D, inner)), wz=ParamSpec((D, inner)),
        wB=ParamSpec((D, H * N)), wC=ParamSpec((D, H * N)),
        wdt=ParamSpec((D, H)),
        dt_bias=ParamSpec((H,), init="zeros"),
        A_log=ParamSpec((H, N), init="zeros"),
        Ddiag=ParamSpec((H,), init="ones"),
        wo=ParamSpec((inner, D)),
    )


def mamba_init_state(cfg: ModelConfig, batch: int,
                     device="cuda") -> torch.Tensor:
    """(batch, H, N, hd) f32 zeros, whatever the cache's type."""
    H, hd, N = cfg.num_heads, cfg.hd, cfg.ssm_state
    return torch.zeros((batch, H, N, hd), dtype=f32,
                       device=resolve_device(device))


def _mamba_inputs(params, cfg: ModelConfig, x: torch.Tensor):
    dt_ = x.dtype
    B, S, _ = x.shape
    H, hd, N = cfg.num_heads, cfg.hd, cfg.ssm_state
    xv = (x @ params["wx"].to(dt_)).reshape(B, S, H, hd)
    z = (x @ params["wz"].to(dt_)).reshape(B, S, H, hd)
    Bm = (x @ params["wB"].to(dt_)).reshape(B, S, H, N).to(f32)
    Cm = (x @ params["wC"].to(dt_)).reshape(B, S, H, N).to(f32)
    dt = F.softplus((x @ params["wdt"].to(dt_)).to(f32)
                    + params["dt_bias"].to(f32))
    A = -torch.exp(params["A_log"].to(f32))                  # (H, N) < 0
    return xv, z, Bm, Cm, dt, A


def _mamba_out(params, x: torch.Tensor, y: torch.Tensor, xv, z):
    """y (B, S, H, hd) in x's type → D skip, SiLU gate, output projection."""
    dt_ = x.dtype
    B, S, H, hd = xv.shape
    y = y + params["Ddiag"].to(dt_)[None, None, :, None] * xv
    y = (y * F.silu(z)).reshape(B, S, H * hd)
    return y @ params["wo"].to(dt_)


def mamba_forward(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  state: Optional[torch.Tensor] = None, *, chunk: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence selective scan, x (B, S, D) → (y, final state).

    Chunkwise: within a chunk the recurrence h_t = exp(dt_t A) h_{t-1} +
    dt_t B_t x_t unrolls through cumulative log decays (A < 0, so decays
    are at most 1); inputs are scaled by the inverse decay, guarded at
    1e-30, summed and rescaled."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.hd
    xv, z, Bm, Cm, dt, A = _mamba_inputs(params, cfg, x)
    h = (mamba_init_state(cfg, B, device=x.device) if state is None
         else state)
    c = min(chunk, S)
    pad = -S % c
    ys = []
    for xc, Bc, Cc, dtc in zip(*(_chunks(_pad_seq(a, pad), c) for a in (
            xv.to(f32), Bm, Cm, dt))):
        cum = torch.cumsum(dtc[..., None] * A, dim=1)          # (B, c, H, N)
        w = torch.exp(cum)[..., None]                           # (B,c,H,N,1)
        h_part = w * h[:, None]
        inj = (dtc[..., None] * Bc)[..., None] * xc[..., None, :]
        csum = torch.cumsum(inj / torch.clamp(w, min=1e-30), dim=1)
        h_all = h_part + w * csum                               # (B,c,H,N,hd)
        ys.append(torch.einsum("bchn,bchnd->bchd", Cc, h_all))
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1)[:, :S].to(x.dtype)
    return _mamba_out(params, x, y, xv, z), h


def mamba_step(params: Dict, cfg: ModelConfig, x: torch.Tensor,
               state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token decode: x (B, 1, D), state (B, H, N, hd)."""
    xv, z, Bm, Cm, dt, A = _mamba_inputs(params, cfg, x)
    decay = torch.exp(dt[:, 0, :, None] * A)                   # (B, H, N)
    inj = (dt[:, 0, :, None] * Bm[:, 0])[..., None] * \
        xv[:, 0].to(f32)[..., None, :]                          # (B,H,N,hd)
    h = decay[..., None] * state + inj
    y = torch.einsum("bhn,bhnd->bhd", Cm[:, 0], h).to(x.dtype)
    return _mamba_out(params, x, y[:, None], xv, z), h


# ------------------------------------------------------------------ mLSTM --


def mlstm_specs(cfg: ModelConfig) -> Dict:
    """mLSTM (xLSTM matrix-memory cell), H heads of size hd."""
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.hd
    inner = H * hd
    return dict(
        wq=ParamSpec((D, inner)), wk=ParamSpec((D, inner)),
        wv=ParamSpec((D, inner)),
        wi=ParamSpec((D, H)), wf=ParamSpec((D, H)),
        bi=ParamSpec((H,), init="zeros"), bf=ParamSpec((H,), init="ones"),
        ogate=ParamSpec((D, inner)),
        norm=ParamSpec((hd,), init="ones"),
        wo=ParamSpec((inner, D)),
    )


def mlstm_init_state(cfg: ModelConfig, batch: int, device="cuda") -> Dict:
    """``C`` (batch, H, hd, hd), ``n`` (batch, H, hd), ``m`` (batch, H),
    f32; m starts at -1e30."""
    H, hd = cfg.num_heads, cfg.hd
    device = resolve_device(device)
    return dict(C=torch.zeros((batch, H, hd, hd), dtype=f32, device=device),
                n=torch.zeros((batch, H, hd), dtype=f32, device=device),
                m=torch.full((batch, H), -1e30, dtype=f32, device=device))


def _mlstm_inputs(params, cfg: ModelConfig, x: torch.Tensor):
    dt_ = x.dtype
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.hd
    q = (x @ params["wq"].to(dt_)).reshape(B, S, H, hd)
    k = (x @ params["wk"].to(dt_)).reshape(B, S, H, hd) / torch.sqrt(
        torch.tensor(hd, dtype=f32)).to(dt_)
    v = (x @ params["wv"].to(dt_)).reshape(B, S, H, hd)
    o = torch.sigmoid(x @ params["ogate"].to(dt_))
    ig = (x @ params["wi"].to(dt_)).to(f32) + params["bi"]
    fg = (x @ params["wf"].to(dt_)).to(f32) + params["bf"]
    return q, k, v, o, ig, fg


def _headwise_rmsnorm(y: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    y32 = y.to(f32)
    var = torch.mean(y32 ** 2, dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + eps) * w.to(f32)).to(y.dtype)


def _mlstm_out(params, x: torch.Tensor, y: torch.Tensor, o: torch.Tensor):
    """y (B, S, H, hd) → head-wise norm, output gate, projection."""
    B, S, H, hd = y.shape
    y = _headwise_rmsnorm(y, params["norm"]).reshape(B, S, H * hd)
    return (y * o.reshape(B, S, H * hd)) @ params["wo"].to(x.dtype)


def mlstm_forward(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  state: Optional[Dict] = None, *, chunk: int = 256
                  ) -> Tuple[torch.Tensor, Dict]:
    """Chunkwise-parallel mLSTM (stabilized log-space gates)."""
    B, S, _ = x.shape
    dt_ = x.dtype
    q, k, v, o, ig, fg = _mlstm_inputs(params, cfg, x)
    st = (mlstm_init_state(cfg, B, device=x.device) if state is None
          else state)
    C0, n0, m0 = st["C"], st["n"], st["m"]
    c = min(chunk, S)
    pad = -S % c
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=x.device))
    ys = []
    # pads: no input (i = -1e30), full forget (f = 30)
    for qc, kc, vc, ic, fc in zip(*(_chunks(a, c) for a in (
            _pad_seq(q, pad), _pad_seq(k, pad), _pad_seq(v, pad),
            _pad_seq(ig, pad, -1e30), _pad_seq(fg, pad, 30.0)))):
        qc, kc, vc = qc.to(f32), kc.to(f32), vc.to(f32)
        Fc = torch.cumsum(F.logsigmoid(fc), dim=1)          # (B, c, H)
        # log weights of the carried state (b_t = F_t + m0) and of source
        # u at t (F_t - F_u + i_u)
        b = Fc + m0[:, None, :]
        src = Fc[:, None] * 0 + ic[:, None] - Fc[:, None] + Fc[:, :, None]
        src = torch.where(causal[None, :, :, None], src, -torch.inf)
        m_new = torch.maximum(b, src.amax(dim=2))            # (B, c, H)
        w_intra = torch.exp(src - m_new[:, :, None, :])      # (B, t, u, H)
        s = torch.einsum("bthd,buhd->btuh", qc, kc)
        y_intra = torch.einsum("btuh,btuh,buhd->bthd", s, w_intra, vc)
        n_intra = torch.einsum("btuh,btuh,buhd->bthd", s * 0 + 1.0, w_intra,
                               kc)
        n_intra = torch.einsum("bthd,bthd->bth", qc, n_intra)
        w_c = torch.exp(b - m_new)
        y = y_intra + w_c[..., None] * torch.einsum("bthd,bhde->bthe", qc,
                                                    C0)
        nrm = n_intra + w_c * torch.einsum("bthd,bhd->bth", qc, n0)
        denom = torch.maximum(nrm.abs(), torch.exp(-m_new))[..., None]
        ys.append((y / denom).to(dt_))
        # the chunk's final state
        mT = m_new[:, -1]                                    # (B, H)
        decay_all = torch.exp(Fc[:, -1:] - Fc + ic - mT[:, None])
        carry = torch.exp(Fc[:, -1] + m0 - mT)
        C0 = carry[..., None, None] * C0 + torch.einsum(
            "buh,buhd,buhe->bhde", decay_all, kc, vc)
        n0 = carry[..., None] * n0 + torch.einsum("buh,buhd->bhd",
                                                  decay_all, kc)
        m0 = mT
    y = torch.cat(ys, dim=1)[:, :S]
    return _mlstm_out(params, x, y, o), dict(C=C0, n=n0, m=m0)


def mlstm_step(params: Dict, cfg: ModelConfig, x: torch.Tensor,
               state: Dict) -> Tuple[torch.Tensor, Dict]:
    """Single-token recurrent mLSTM update."""
    q, k, v, o, ig, fg = _mlstm_inputs(params, cfg, x)
    q1, k1, v1 = (a[:, 0].to(f32) for a in (q, k, v))
    i1, f1 = ig[:, 0], fg[:, 0]
    logf = F.logsigmoid(f1)
    m_new = torch.maximum(logf + state["m"], i1)
    fw = torch.exp(logf + state["m"] - m_new)[..., None]
    iw = torch.exp(i1 - m_new)[..., None]
    C = fw[..., None] * state["C"] + (iw * k1)[..., None] * v1[:, :, None, :]
    n = fw * state["n"] + iw * k1
    y = torch.einsum("bhd,bhde->bhe", q1, C)
    nrm = torch.einsum("bhd,bhd->bh", q1, n)
    denom = torch.maximum(nrm.abs(), torch.exp(-m_new))[..., None]
    y = (y / denom).to(x.dtype)[:, None]                     # (B, 1, H, hd)
    return _mlstm_out(params, x, y, o), dict(C=C, n=n, m=m_new)


# ------------------------------------------------------------------ sLSTM --

GATES = ("i", "f", "z", "o")


def slstm_specs(cfg: ModelConfig) -> Dict:
    """sLSTM: scalar memory, exponential gating, head-blocked recurrence."""
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.hd
    inner = H * hd
    p = {}
    for g in GATES:
        p[f"w{g}"] = ParamSpec((D, inner))
        p[f"r{g}"] = ParamSpec((H, hd, hd), scale=0.01)
        p[f"b{g}"] = ParamSpec((inner,), init="ones" if g == "f" else "zeros")
    p["norm"] = ParamSpec((hd,), init="ones")
    p["wo"] = ParamSpec((inner, D))
    return p


def slstm_init_state(cfg: ModelConfig, batch: int, device="cuda") -> Dict:
    """``c``, ``n``, ``h`` zeros and ``m`` -1e30, each (batch, H, hd) f32."""
    H, hd = cfg.num_heads, cfg.hd
    device = resolve_device(device)

    def full(v):
        return torch.full((batch, H, hd), v, dtype=f32, device=device)

    return dict(c=full(0.0), n=full(0.0), h=full(0.0), m=full(-1e30))


def slstm_forward(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  state: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """A step loop over the sequence: the hidden state feeds back into
    the gates through R, so the steps run one after another (one host
    iteration a token)."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.hd
    dt_ = x.dtype
    st = (slstm_init_state(cfg, B, device=x.device) if state is None
          else state)
    pre = [((x @ params[f"w{g}"].to(dt_)).to(f32) + params[f"b{g}"])
           .reshape(B, S, H, hd) for g in GATES]
    # the four recurrent matrices side by side: one (H, hd, 4 hd) product
    R = torch.cat([params[f"r{g}"].to(f32) for g in GATES], dim=-1)
    c, n, h, m = st["c"], st["n"], st["h"], st["m"]
    hs = []
    for t in range(S):
        rec = torch.bmm(h.transpose(0, 1), R).transpose(0, 1)  # (B, H, 4hd)
        ri, rf, rz, ro = rec.split(hd, dim=-1)
        it = pre[0][:, t] + ri
        ft = pre[1][:, t] + rf
        zt = torch.tanh(pre[2][:, t] + rz)
        ot = torch.sigmoid(pre[3][:, t] + ro)
        logf = F.logsigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        iw = torch.exp(it - m_new)
        fw = torch.exp(logf + m - m_new)
        c = fw * c + iw * zt
        n = torch.maximum(fw * n + iw, torch.exp(-m_new))
        h = ot * (c / n)
        m = m_new
        hs.append(h.to(dt_))
    y = torch.stack(hs, dim=1)                                # (B, S, H, hd)
    y = _headwise_rmsnorm(y, params["norm"]).reshape(B, S, H * hd)
    return y @ params["wo"].to(dt_), dict(c=c, n=n, h=h, m=m)


def slstm_step(params: Dict, cfg: ModelConfig, x: torch.Tensor,
               state: Dict) -> Tuple[torch.Tensor, Dict]:
    return slstm_forward(params, cfg, x, state)
