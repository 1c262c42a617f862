"""The plain query: what the upstream model answers for a k-mer
(``KModel::kmer_to_occ``, kmodel.hpp:100-116 and 286-359), on a
``kmodel.RefModel``, in PyTorch.

1. The canonical k-mer is looked up in the exact rest store; a hit is the
   answer.  The lookup searches the k-mer's prefix bucket over the
   inclusive range [start, next start] (rest.hpp:236-247), so a key above
   every suffix of its bucket that equals the next bucket's first suffix
   takes that entry's count.
2. Otherwise the Bloom pairs are probed in order (1, 0, 2 when ci > 1); a
   hit in both filters of pair i gives ci + i.  Unless the middle is in
   ``km_back``, that is the answer (0 without a hit).
3. Otherwise each coupled array whose nh tags are all set gives a bin, its
   value bits read least significant first.  No bin above 0: the Bloom
   count.  One: the bin, unless the Bloom count is not 0 and at least half
   of the 8 shifted neighbours that resolve (rest store, Bloom pair, or an
   array) have a count under ci + bf_num, when it is the Bloom count.
   Several: the first bin nearest to any neighbour's value, 0 without
   neighbours.  The bin is then decoded to its mean.

``resolve=False`` is the control: step 3 takes the first bin above 0 and
asks no neighbour.
"""

from __future__ import annotations

import torch

from kbench.reference import murmur
from kbench.reference.kmodel import RefModel, hash_positions

_BLOCK = 1 << 20


def canonical(v: torch.Tensor, k: int) -> torch.Tensor:
    rc = torch.zeros_like(v)
    for t in range(k):
        rc |= (3 - ((v >> (2 * t)) & 3)) << (2 * (k - 1 - t))
    return torch.minimum(v, rc)


def _in_filter(bits: torch.Tensor, v: torch.Tensor, length: int,
               nhash: int) -> torch.Tensor:
    pos = hash_positions(v, length, murmur.SEEDS[:nhash], bits.numel())
    return bits[pos].all(1)


def _rest(m: RefModel, q: torch.Tensor) -> torch.Tensor:
    keys, counts = m.rest_kmers, m.rest_counts
    out = torch.zeros(q.numel(), dtype=torch.int64, device=q.device)
    n = keys.numel()
    if n == 0:
        return out
    shift = 2 * (m.k - m.pre_len)
    lo = torch.searchsorted(keys, (q >> shift) << shift)
    hi = torch.searchsorted(keys, ((q >> shift) + 1) << shift)
    pos = torch.searchsorted(keys, q)
    at = keys[pos.clamp(max=n - 1)]
    hit = (pos < hi) & (at == q)
    out[hit] = counts[pos[hit]]
    mask = (1 << shift) - 1
    nxt = (~hit) & (hi > lo) & (hi < n) & (pos >= hi)
    nxt &= (keys[hi.clamp(max=n - 1)] & mask) == (q & mask)
    out[nxt] = counts[hi[nxt]]
    return out


def _bloom(m: RefModel, q: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(q.numel(), dtype=torch.int64, device=q.device)
    undecided = torch.ones(q.numel(), dtype=torch.bool, device=q.device)
    mid = murmur.middle(q, m.k)
    for i in ([0] if m.ci == 1 else [1, 0, 2]):
        hit = (undecided & _in_filter(m.bf[i], q, m.k, m.nh - 1)
               & _in_filter(m.bf_back[i], mid, m.k - 2, m.nh - 2))
        out[hit] = m.ci + i
        undecided &= ~hit
    return out


def _arrays(m: RefModel, q: torch.Tensor) -> torch.Tensor:
    """[n, nb] bins, -1 where a tag is missing."""
    nb, nh = m.nb, m.nh
    bits = m.bit1.shape[1]
    seeds = [murmur.SEEDS[(a * nh + j) % 128] for a in range(nb)
             for j in range(nh)]
    pos = hash_positions(q, m.k, seeds, bits).view(-1, nb, nh)
    arr = torch.arange(nb, device=q.device)[None, :, None]
    val = m.bit1[arr, pos].long()
    tag = m.bit2[arr, pos].all(2)
    b = (val << torch.arange(nh, device=q.device)).sum(2)
    return torch.where(tag, b, -1)


def _in_back(m: RefModel, q: torch.Tensor) -> torch.Tensor:
    return _in_filter(m.km_back, murmur.middle(q, m.k), m.k - 2, m.nh - 2)


def _neighbours(m: RefModel, q: torch.Tensor):
    """(values [n, 8], valid [n, 8]) of the 8 shifted neighbours."""
    k, dev = m.k, q.device
    b = torch.arange(4, device=dev)
    fwd = ((q[:, None] << 2) & ((1 << (2 * k)) - 1)) | b
    bwd = (q[:, None] >> 2) | (b << (2 * (k - 1)))
    nb_ = canonical(torch.cat([fwd, bwd], 1).reshape(-1), k)
    vals = torch.zeros(nb_.numel(), dtype=torch.int64, device=dev)
    valid = torch.zeros(nb_.numel(), dtype=torch.bool, device=dev)
    rc = _rest(m, nb_)
    hit = rc > 0
    vals[hit] = m.occ2bin[rc[hit].clamp(max=m.occ2bin.numel() - 1)]
    valid |= hit
    rem = torch.nonzero(~valid)[:, 0]
    if rem.numel():
        bf = _bloom(m, nb_[rem])
        sel = rem[bf != 0]
        vals[sel] = bf[bf != 0]
        valid[sel] = True
    rem = torch.nonzero(~valid)[:, 0]
    if rem.numel():
        back = rem[_in_back(m, nb_[rem])]
        if back.numel():
            B = _arrays(m, nb_[back])
            ok = B != -1
            nz = ok & (B != 0)
            first_nz = B.gather(1, nz.int().argmax(1, keepdim=True))[:, 0]
            v = torch.where(nz.any(1), first_nz, 0)
            vals[back] = torch.where(ok.any(1), v, 0)
            valid[back] = ok.any(1)
    return vals.view(-1, 8), valid.view(-1, 8)


def _to_bin(m: RefModel, q: torch.Tensor, occ: torch.Tensor,
            resolve: bool) -> torch.Tensor:
    B = _arrays(m, q)
    pos = B > 0
    nbin = pos.sum(1)
    first = torch.where(pos.any(1),
                        B.gather(1, pos.int().argmax(1, keepdim=True))[:, 0], 0)
    result = torch.where(nbin == 0, occ, first)
    if not resolve:
        return result
    need = ((nbin == 1) & (occ != 0)) | (nbin >= 2)
    cv = torch.zeros((q.numel(), 8), dtype=torch.int64, device=q.device)
    cm = torch.zeros((q.numel(), 8), dtype=torch.bool, device=q.device)
    idx = torch.nonzero(need)[:, 0]
    if idx.numel():
        cv[idx], cm[idx] = _neighbours(m, q[idx])
    n_cand = cm.sum(1)
    low = (cm & (cv < m.ci + m.bf_num)).sum(1)
    take_occ = (nbin == 1) & (occ != 0) & (low >= n_cand // 2)
    result = torch.where(take_occ, occ, result)
    multi = nbin >= 2
    dist = (B[:, :, None] - cv[:, None, :]).abs()
    dist = torch.where(cm[:, None, :], dist, 1 << 21).amin(2)
    dist = torch.where(pos, dist, 1 << 22)
    best = B.gather(1, dist.argmin(1, keepdim=True))[:, 0]
    best = torch.where(cm.any(1), best, 0)
    return torch.where(multi, best, result)


def answer(m: RefModel, queries: torch.Tensor, resolve: bool = True):
    """int64 answers to int64 k-mers (either strand), block by block."""
    out = torch.empty(queries.numel(), dtype=torch.int64,
                      device=queries.device)
    for a in range(0, queries.numel(), _BLOCK):
        out[a : a + _BLOCK] = _answer(m, queries[a : a + _BLOCK], resolve)
    return out


def _answer(m: RefModel, q: torch.Tensor, resolve: bool) -> torch.Tensor:
    q = canonical(q, m.k)
    out = _rest(m, q)
    todo = torch.nonzero(out == 0)[:, 0]
    if not todo.numel():
        return out
    qt = q[todo]
    back = _in_back(m, qt)
    occ = _bloom(m, qt)
    out[todo] = torch.where(back, 0, occ)
    deep = torch.nonzero(back)[:, 0]
    if deep.numel():
        b = _to_bin(m, qt[deep], occ[deep], resolve)
        top = m.bin2mean.numel()
        out[todo[deep]] = torch.where(b < top, m.bin2mean[b.clamp(0, top - 1)],
                                      0)
    return out
