"""Plain statevector QAOA of subgraphs: the benchmark's own reference for
the batched QAOA stage.

Written from the algorithm, not from the program: |+>^n, then p layers of
the cost phase e^{-iγC} and the transverse-field mixer e^{-iβΣX_q}
(RX(2β) on every qubit), Adam ascent on ⟨C⟩ from the linear ramp with
gradients by the adjoint method, then the final probabilities.

States are (rows, 2^n) real and imaginary planes, one row a subgraph of
n vertices, each row with its own angles. The mixer acts on groups of
qubits through the Kronecker power of the 2×2 rotation, a matrix product
on a view of the state (cuBLAS's on the card). ``precision`` "float64" is the
reference; "tf32" is the control: float32 states whose matrix products
take their inputs at TF32's 10-bit mantissa (rounded here, so the CPU
gives what the card's TF32 products give; on the card
``torch.backends.cuda.matmul.allow_tf32`` is set as well, see
`tf32_products`).

A subgraph of n vertices runs on n qubits. The solver under test pads it
to its qubit budget with isolated vertices; each such qubit stays in |+>,
an eigenstate of the mixer, so it changes neither the probabilities of
the real qubits nor ⟨C⟩ nor any gradient: dropping it is exact.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

GROUP = 8  # qubits per mixer matrix (256 × 256)
ADAM = (0.9, 0.999, 1e-8)  # β1, β2, ε
DTYPES = {"float64": torch.float64, "float32": torch.float32, "tf32": torch.float32}


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def tf32_products():
    """Let float32 matrix products on the card run in TF32."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def cut_tables(n: int, edges, weights, dtype, device):
    """(rows, 2^n) cut value of every basis state of every row:
    Σ_e w_e·[bit u ≠ bit v]. ``edges`` (rows, E, 2), ``weights`` (rows, E),
    rows padded with weight-0 edges."""
    x = torch.arange(2**n, dtype=torch.int64, device=device)
    e = torch.as_tensor(np.asarray(edges, dtype=np.int64), device=device)
    w = torch.as_tensor(np.asarray(weights, dtype=np.float64), device=device).to(dtype)
    c = torch.zeros((e.shape[0], 2**n), dtype=dtype, device=device)
    for j in range(e.shape[1]):
        crossed = ((x[None] >> e[:, j, 0:1]) ^ (x[None] >> e[:, j, 1:2])) & 1
        c += w[:, j:j + 1] * crossed.to(dtype)
    return c


def _groups(n: int):
    return [(lo, min(GROUP, n - lo)) for lo in range(0, n, GROUP)]


def _rx_power(beta, k: int, dtype):
    """(re, im) of RX(2β)^{⊗k} = e^{-iβ Σ X_q} on k qubits for each row's
    β (rows,): (rows, 2^k, 2^k) each, built in complex128."""
    b = beta.to(torch.float64)
    c = torch.cos(b).to(torch.complex128)
    s = -1j * torch.sin(b).to(torch.complex128)
    one = torch.stack([torch.stack([c, s], -1), torch.stack([s, c], -1)], -2)
    m = torch.ones((b.shape[0], 1, 1), dtype=torch.complex128, device=b.device)
    for _ in range(k):
        m = (one[:, :, None, :, None] * m[:, None, :, None, :]).reshape(
            b.shape[0], 2 * m.shape[1], 2 * m.shape[2])
    return m.real.to(dtype), m.imag.to(dtype)


def _x_sum(k: int, dtype, device):
    """Σ_q X_q on k qubits, (2^k, 2^k): 1 where two indices differ in one bit."""
    a = torch.arange(2**k, device=device)
    d = a[:, None] ^ a[None, :]
    return (((d & (d - 1)) == 0) & (d != 0)).to(dtype)


def _on_group(mat, x, n: int, lo: int, k: int, precision: str):
    """Apply ``mat`` ((rows, 2^k, 2^k), or one (2^k, 2^k) for every row)
    to qubits [lo, lo + k) of the (rows, 2^n) planes ``x``."""
    if precision == "tf32":
        mat, x = to_tf32(mat), to_tf32(x)
    r = x.shape[0]
    v = x.reshape(r, 2 ** (n - lo - k), 2**k, 2**lo)
    if mat.dim() == 2:
        out = torch.einsum("ij,rajl->rail", mat, v)
    else:
        out = torch.einsum("rij,rajl->rail", mat, v)
    return out.reshape(r, -1)


def _mixer(re, im, n: int, beta, precision: str):
    for lo, k in _groups(n):
        c, s = _rx_power(beta, k, DTYPES[precision])
        on = lambda m, x: _on_group(m, x, n, lo, k, precision)
        re, im = on(c, re) - on(s, im), on(c, im) + on(s, re)
    return re, im


def _b_apply(re, im, n: int, precision: str):
    out_re, out_im = torch.zeros_like(re), torch.zeros_like(im)
    for lo, k in _groups(n):
        xs = _x_sum(k, DTYPES[precision], re.device)
        out_re += _on_group(xs, re, n, lo, k, precision)
        out_im += _on_group(xs, im, n, lo, k, precision)
    return out_re, out_im


def _phase(re, im, c, gamma):
    a = gamma[:, None].to(c.dtype) * c
    cs, sn = torch.cos(a), torch.sin(a)
    return re * cs + im * sn, im * cs - re * sn


def _im_inner(a_re, a_im, b_re, b_im):
    """Im Σ conj(a)·b per row."""
    return torch.sum(a_re * b_im - a_im * b_re, dim=1)


def _start(c):
    n = int(math.log2(c.shape[1]))
    re = torch.full_like(c, 2.0 ** (-n / 2))
    return re, torch.zeros_like(c), n


def expectation_and_grad(c, gammas, betas, precision: str):
    """⟨C⟩ (rows,) and its gradients (rows, p) in γ and β, by the adjoint
    method: ∂/∂β_l = 2·Im⟨λ_l, Bψ_l⟩ and ∂/∂γ_l = 2·Im⟨M_l†λ_l, Cφ_l⟩,
    λ_l the cotangent Cψ_p carried back to the output of layer l."""
    re, im, n = _start(c)
    p = gammas.shape[1]
    outs = []
    for l in range(p):
        re, im = _phase(re, im, c, gammas[:, l])
        re, im = _mixer(re, im, n, betas[:, l], precision)
        outs.append((re, im))
    e = torch.sum((re * re + im * im) * c, dim=1)
    lre, lim = c * re, c * im
    dg, db = [None] * p, [None] * p
    for l in reversed(range(p)):
        ore, oim = outs[l]
        bre, bim = _b_apply(ore, oim, n, precision)
        db[l] = 2.0 * _im_inner(lre, lim, bre, bim)
        lre, lim = _mixer(lre, lim, n, -betas[:, l], precision)
        pre, pim = _mixer(ore, oim, n, -betas[:, l], precision)  # φ_l
        dg[l] = 2.0 * _im_inner(lre, lim, c * pre, c * pim)
        lre, lim = _phase(lre, lim, c, -gammas[:, l])
    return e, torch.stack(dg, 1), torch.stack(db, 1)


def optimise(c, p: int, steps: int, lr: float, delta: float, precision: str):
    """Adam ascent on each row's ⟨C⟩ from the linear ramp
    γ_l = δ(l + ½)/p, β_l = δ(1 − (l + ½)/p). Angles and Adam's moments are
    float64 whatever precision the states take."""
    rows = c.shape[0]
    frac = (torch.arange(p, dtype=torch.float64, device=c.device) + 0.5) / p
    theta = torch.cat([delta * frac, delta * (1 - frac)]).repeat(rows, 1)
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    b1, b2, eps = ADAM
    for t in range(1, steps + 1):
        _, dg, db = expectation_and_grad(c, theta[:, :p], theta[:, p:], precision)
        g = -torch.cat([dg, db], 1).to(torch.float64)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        theta = theta - lr * (m / (1 - b1**t)) / (torch.sqrt(v / (1 - b2**t)) + eps)
    return theta[:, :p], theta[:, p:]


def probabilities(c, gammas, betas, precision: str):
    """(rows, 2^n) probabilities after the p layers at the given angles."""
    re, im, n = _start(c)
    for l in range(gammas.shape[1]):
        re, im = _phase(re, im, c, gammas[:, l])
        re, im = _mixer(re, im, n, betas[:, l], precision)
    return re * re + im * im


def solve_rows(n: int, edges, weights, *, p: int, steps: int, lr: float,
               delta: float, precision: str = "float64", device="cpu"):
    """Subgraphs of n vertices each: (cut tables, optimised probabilities),
    (rows, 2^n) each."""
    c = cut_tables(n, edges, weights, DTYPES[precision], device)
    gammas, betas = optimise(c, p, steps, lr, delta, precision)
    return c, probabilities(c, gammas, betas, precision)


def top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """(rows, k) most likely basis states, ties to the lower index."""
    return torch.sort(probs, dim=1, descending=True, stable=True).indices[:, :k]
