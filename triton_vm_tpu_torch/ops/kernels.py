"""The prover's vector algebra on tensors: out-of-domain rows from the
committed polynomials' coefficients, quotient-segment values by
barycentric evaluation, weighted column sums and the DEEP combination
codeword. The counterpart of `triton_vm_tpu.ops.kernels` (stark.rs DEEP
codewords, master_table.rs weighted column sums and out-of-domain rows).

Base-field columns are int64 (m, n); extension-field columns are XFE
tensors (3, q, n); points and weights are XFE tensors (3, k). Whole
tables are reduced a block of columns at a time (`gf.block_rows`), so the
temporaries stay a few GB however many columns there are.
"""

from __future__ import annotations

import torch

from . import gf, gfx, ntt


def weighted_column_sum(main_cols, aux_cols, w_main, w_aux):
    """sum_i w_main[i] * main_cols[i] + sum_j w_aux[j] * aux_cols[j]:
    int64 (m, n), XFE (3, q, n), XFE (3, m), XFE (3, q) -> XFE (3, n)
    (master_table.rs weighted_sum_of_columns)."""
    n = main_cols.shape[-1]
    out = gfx.zeros((n,), main_cols.device)
    step = gf.block_rows(n)
    for s in range(0, main_cols.shape[0], step):
        blk = main_cols[s:s + step]
        out = gf.add(out, torch.stack([
            gf.reduce_sum(gf.mul(blk, w_main[c, s:s + step, None]), 0)
            for c in range(3)]))
    step = gf.block_rows(3 * n)
    for s in range(0, aux_cols.shape[1], step):
        prod = gfx.mul(aux_cols[:, s:s + step], w_aux[:, s:s + step, None])
        out = gf.add(out, gfx.reduce_sum(prod, 0))
    return out


def _row_dots(cols_gf, cols_gfx, vecs):
    """sum_r vecs[:, i, r] * cols[j, r] for each of k XFE vectors and each
    column j: int64 (m, n) -> XFE (3, k, m), XFE (3, q, n) -> XFE (3, k, q)
    (None -> None); vecs: XFE (3, k, n)."""
    k, n = vecs.shape[1], vecs.shape[2]
    out_gf = out_gfx = None
    if cols_gf is not None:
        out_gf = torch.empty((3, k, cols_gf.shape[0]), dtype=gf.I64,
                             device=vecs.device)
        step = gf.block_rows(n)
        for s in range(0, cols_gf.shape[0], step):
            blk = cols_gf[s:s + step]
            out_gf[:, :, s:s + step] = torch.stack([torch.stack([
                gf.reduce_sum(gf.mul(blk, vecs[c, i][None, :]), 1)
                for i in range(k)]) for c in range(3)])
    if cols_gfx is not None:
        out_gfx = torch.empty((3, k, cols_gfx.shape[1]), dtype=gf.I64,
                              device=vecs.device)
        step = gf.block_rows(3 * n)
        for s in range(0, cols_gfx.shape[1], step):
            blk = cols_gfx[:, s:s + step]
            out_gfx[:, :, s:s + step] = torch.stack([
                gfx.reduce_sum(gfx.mul(blk, vecs[:, i][:, None, :]), 1)
                for i in range(k)], dim=1)
    return out_gf, out_gfx


def _bary_eval_multi(cols, xs, points):
    """Barycentric evaluation of every XFE column's interpolant at k
    out-of-domain XFE points (the quotient segments' values, stark.rs:
    520-560, from their codewords on the domain xs).

    cols: XFE (3, q, n); xs: int64 (n,) domain values; points: XFE (3, k).
    Returns XFE (3, k, q)."""
    shifts = points[:, :, None].expand(3, points.shape[1], xs.shape[0])
    shifts = torch.stack([gf.sub(shifts[0], xs[None, :]), shifts[1],
                          shifts[2]])                       # (3, k, n)
    dods = gfx.bfe_mul(gfx.inv(shifts), xs[None, :])        # (3, k, n)
    dinv = gfx.inv(gfx.reduce_sum(dods, 1))                 # (3, k)
    _, num = _row_dots(None, cols, dods)
    return gfx.mul(num, dinv[:, :, None])


def _xfe_powers(points, n):
    """points^j for j < n: XFE (3, k) -> XFE (3, k, n), by doubling."""
    k = points.shape[1]
    pw = gfx.zeros((k, n), points.device)
    pw[0, :, 0] = 1
    cur, size = points, 1
    while size < n:
        step = min(size, n - size)
        pw[:, :, size:size + step] = gfx.mul(pw[:, :, :step],
                                             cur[:, :, None])
        cur = gfx.mul(cur, cur)
        size *= 2
    return pw


def poly_eval_multi(coeffs_gf, coeffs_gfx, points):
    """Every column's polynomial at k XFE points, from its coefficients:
    int64 (m, n) or None, XFE (3, q, n) or None, points XFE (3, k) ->
    (XFE (3, k, m) or None, XFE (3, k, q) or None)."""
    n = (coeffs_gf if coeffs_gf is not None else coeffs_gfx).shape[-1]
    return _row_dots(coeffs_gf, coeffs_gfx, _xfe_powers(points, n))


def ood_stage_fn(main, aux, segs, alpha, omega_alpha, apk, zapk, xs_l):
    """The out-of-domain stage (stark.rs:520-560): randomized main/aux
    rows at alpha and omega*alpha, from the committed polynomials'
    coefficients (main int64 (m, n), aux XFE (3, q, n)), and all 5
    quotient-segment evaluations at alpha^k and (zeta*alpha)^k (segments
    (3, 5, L) on the LDT domain xs_l, barycentric). Points are XFE (3,);
    returns six XFE tensors: (main@alpha (3, m), aux@alpha (3, q),
    main@omega_alpha, aux@omega_alpha, segs@apk (3, 5), segs@zapk (3, 5))."""
    m12, a12 = poly_eval_multi(main, aux,
                               torch.stack([alpha, omega_alpha], dim=1))
    s12 = _bary_eval_multi(segs, xs_l, torch.stack([apk, zapk], dim=1))
    return (m12[:, 0], a12[:, 0], m12[:, 1], a12[:, 1], s12[:, 0],
            s12[:, 1])


def deep_combination_fn(cw_ma, segs, w_qs, w_deep, points, values, xs_s,
                        s_off, l_len, l_off, stride_seg):
    """The DEEP combination codeword (stark.rs:560-644):

    - the weighted sum of the committed main/aux codewords on the short
      domain xs_s, given (`weighted_column_sum`),
    - the two weighted quotient-segment codewords (zeta-chain p/r split),
    - the four DEEP codewords (cw - ood_value) / (x - ood_point),
    - their weighted sum, low-degree extended from the short domain
      (offset s_off) to the FRI domain (l_len, offset l_off) when the two
      differ.

    cw_ma XFE (3, S); segs XFE (3, 5, L); w_qs (3, 5); w_deep, points,
    values (3, 4). Returns XFE (3, l_len)."""
    S = xs_s.shape[0]
    seg_w = gfx.mul(segs[:, :, ::stride_seg], w_qs[:, :, None])  # (3, 5, S)
    shared = gfx.reduce_sum(seg_w[:, 1:4], 0)
    cw_p = gfx.add(shared, seg_w[:, 0])
    cw_r = gfx.add(shared, seg_w[:, 4])

    cws4 = torch.stack([cw_ma, cw_ma, cw_p, cw_r], dim=1)          # (3, 4, S)
    num = gfx.sub(cws4, values[:, :, None])
    den = points[:, :, None].expand(3, 4, S)
    den = torch.stack([gf.sub(xs_s[None, :], den[0]), gf.neg(den[1]),
                       gf.neg(den[2])])
    dc = gfx.mul(num, gfx.inv(den))
    comb = gfx.reduce_sum(gfx.mul(dc, w_deep[:, :, None]), 0)      # (3, S)
    if S != l_len:
        comb = ntt.lde(comb, l_len // S, s_off, l_off)
    return comb
