"""In which order do PyTorch's 3x3 products on the card sum?  The affine
spheres' rows of the plain path vertex are `(org - c) @ inv.T`
(ops/intersect.py:intersect_spheres) and einsum("nij,nj->ni")
(ops/intersect.py:hit_attributes); KV1 and KV2 repeat them bit for bit only
if they sum each row in the same order (csrc/vertex_common.cuh:matvec_mm,
matvec_bmm).  For each product this prints, of every order of the three
products with and without fused multiply-adds (emulated in float64, exact
but for rare double roundings), the share of results equal to PyTorch's.

    python3 scripts/matvec_order.py [--device cuda:0]   # ~10 s on the GPU
"""
import argparse
import itertools

import torch


def f32(x):
    return x.to(torch.float32)


def fma(x, y, z):
    return f32(x.double() * y.double() + z.double())


def add(x, y):
    return f32(x.double() + y.double())


def orders(a, b):
    """{order: a . b} of (n, 3) rows a, b."""
    p = [f32(a[:, k].double() * b[:, k].double()) for k in range(3)]
    out = {}
    for i, j, k in itertools.permutations(range(3)):
        out[f"fma({k}, fma({j}, p{i}))"] = fma(a[:, k], b[:, k], fma(a[:, j], b[:, j], p[i]))
        out[f"fma({k}, p{i} + p{j})"] = fma(a[:, k], b[:, k], add(p[i], p[j]))
        out[f"fma({j}, p{i}) + p{k}"] = add(fma(a[:, j], b[:, j], p[i]), p[k])
        out[f"(p{i} + p{j}) + p{k}"] = add(add(p[i], p[j]), p[k])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda:0")
    dev = torch.device(ap.parse_args().device)
    g = torch.Generator().manual_seed(0)
    for n in (1000, 1 << 18):
        rows = torch.randn((n, 23), generator=g).to(dev)   # hit_attributes' sphere rows
        pos = (torch.rand((n, 3), generator=g) * 555).to(dev)
        m = torch.randn((3, 3), generator=g).to(dev)
        v = pos - rows[:, 0:3]
        inv = rows[:, 5:14].reshape(n, 3, 3)
        cases = {"(n, 3) @ m.T": (v @ m.T, v, m.expand(n, 3, 3)),
                 "einsum('nij,nj->ni')": (torch.einsum("nij,nj->ni", inv, v), v, inv)}
        for name, (got, vec, mat) in cases.items():
            share = {}
            for r in range(3):
                for order, x in orders(vec, mat[:, r, :]).items():
                    eq = float((x == got[:, r]).float().mean())
                    share[order] = min(share.get(order, 1.0), eq)
            best = sorted(share.items(), key=lambda kv: -kv[1])[:3]
            print(f"{name}, {n} rows on {dev}: " + ", ".join(f"{o} {s:.6f}" for o, s in best),
                  flush=True)


if __name__ == "__main__":
    main()
