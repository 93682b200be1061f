"""K4's backward on fixed inputs, dumped for a bit-for-bit comparison of
two checkouts (say a commit and its parent) on one CUDA card.

From each checkout's root:

    python tools/k4_backward_bits.py dump OUT.pt

then, with either checkout:

    python tools/k4_backward_bits.py compare A.pt B.pt

``dump`` builds the checkout's kernels, runs the forward with lse and
the backward (``flash_attention_bwd_bhsd``) of each self-attention case
below from seed 0 on the card, and saves the outputs with the backward's
launch counts; ``compare`` prints, case by case, whether every output is
bit-equal and the launch counts are equal, and exits 1 if any differs.
"""

import sys
from pathlib import Path

# b, h, kvh, s, d, causal, window, dtype: both routes, head dims 16-256,
# causal or not, windows, GQA, ragged S, the training shapes
CASES = [
    (2, 4, 2, 128, 64, True, None, "float32"),
    (1, 4, 1, 256, 64, True, 64, "float32"),
    (2, 2, 2, 128, 32, True, None, "bfloat16"),
    (1, 14, 2, 1000, 64, True, None, "bfloat16"),
    (1, 14, 2, 1000, 64, True, None, "float32"),
    (1, 16, 1, 1000, 256, True, 300, "bfloat16"),
    (2, 4, 4, 200, 16, False, None, "bfloat16"),
    (1, 8, 2, 130, 32, True, 50, "bfloat16"),
    (1, 4, 1, 96, 32, False, 20, "bfloat16"),
    (1, 14, 2, 4096, 64, True, None, "bfloat16"),
    (1, 16, 1, 4096, 256, True, 2048, "bfloat16"),
    (2, 2, 1, 200, 256, False, 64, "bfloat16"),
]


def dump(path: str) -> None:
    import torch
    sys.path.insert(0, str(Path.cwd() / "src"))
    from repro_torch.kernels.flash_attention import kernel as FK
    out = []
    for b, h, kvh, s, d, causal, window, dtype in CASES:
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dt)
                       for shape in ((b, h, s, d), (b, kvh, s, d),
                                     (b, kvh, s, d), (b, h, s, d)))
        kw = dict(causal=causal, window=window)
        o, lse = FK.flash_attention_bhsd(q, k, v, with_lse=True, **kw)
        FK.reset_launches()
        grads = FK.flash_attention_bwd_bhsd(q, k, v, o, do, lse, **kw)
        torch.cuda.synchronize()
        out.append({"o": o.cpu(), "lse": lse.cpu(),
                    "grads": [x.cpu() for x in grads],
                    "launches": dict(FK.BACKWARD_LAUNCHES)})
    torch.save(out, path)
    print(f"dumped {len(out)} cases to {path}")


def compare(a_path: str, b_path: str) -> int:
    import torch
    a, b = torch.load(a_path), torch.load(b_path)
    bad = 0
    for case, x, y in zip(CASES, a, b):
        same = (torch.equal(x["o"], y["o"]) and torch.equal(x["lse"], y["lse"])
                and all(torch.equal(p, q)
                        for p, q in zip(x["grads"], y["grads"])))
        launches = x["launches"] == y["launches"]
        print(case, "bit-equal" if same else "DIFFER",
              "launches equal" if launches else "LAUNCHES DIFFER",
              x["launches"])
        bad += not (same and launches)
    print("all bit-equal" if not bad else f"{bad} cases differ")
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["dump"] and len(sys.argv) == 3:
        dump(sys.argv[2])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
