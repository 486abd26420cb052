#!/usr/bin/env python3
"""Build-time filter: make a CUDA .cu file compilable by plain g++.

Used to compile the *reference's own CPU code paths* (read in place from
/root/reference — never copied into the repo) into `libref_oracle.so`, so the
reference implementation itself can be executed as a bit-exactness oracle
against the JAX pipeline (the non-FFT chain: tfhe_bootstrap at
lwe-bootstrapping-functions.cu:159-182 over exact-integer polynomial
multiplication, multiplication.cu:53-143).

Only two transformations, both removing GPU-only code that the CPU call graph
never reaches:

1. `__global__` kernel definitions are removed entirely (their bodies use
   threadIdx/blockIdx, which do not exist off-device).
2. kernel launch statements `name<<<grid, block>>>(args)` are replaced by an
   abort call (they only occur inside `_16`/GPU host wrappers that the oracle
   never calls; aborting makes any accidental call loud instead of silent).

Both are comment- and string-aware (the reference keeps commented-out launch
debugging blocks, e.g. lwe-keyswitch-functions.cu:407-446). Everything else —
every line of CPU logic — passes through unmodified.
"""
import re
import sys


def code_mask(text: str):
    """mask[i] True iff text[i] is real code (not comment/string literal)."""
    n = len(text)
    mask = [True] * n
    i = 0
    while i < n:
        c = text[i]
        two = text[i:i + 2]
        if two == "//":
            j = text.find("\n", i)
            j = n if j < 0 else j
            for k in range(i, j):
                mask[k] = False
            i = j
        elif two == "/*":
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            for k in range(i, j):
                mask[k] = False
            i = j
        elif c == '"' or c == "'":
            q = c
            j = i + 1
            while j < n and text[j] != q:
                j += 2 if text[j] == "\\" else 1
            j = min(j + 1, n)
            for k in range(i + 1, j):
                mask[k] = False
            i = j
        else:
            i += 1
    return mask


def _match_forward(text: str, mask, i: int, open_ch: str, close_ch: str) -> int:
    """Index just past the matching close_ch for the open_ch at text[i],
    counting only code characters."""
    assert text[i] == open_ch and mask[i]
    depth = 0
    n = len(text)
    while i < n:
        if mask[i]:
            if text[i] == open_ch:
                depth += 1
            elif text[i] == close_ch:
                depth -= 1
                if depth == 0:
                    return i + 1
        i += 1
    raise ValueError("unbalanced %r" % open_ch)


def strip_cuda(text: str) -> str:
    # pass 1: remove __global__ kernel definitions
    out = []
    pos = 0
    mask = code_mask(text)
    for m in re.finditer(r"__global__", text):
        if m.start() < pos or not mask[m.start()]:
            continue
        brace = text.index("{", m.end())
        while not mask[brace]:
            brace = text.index("{", brace + 1)
        end = _match_forward(text, mask, brace, "{", "}")
        out.append(text[pos:m.start()])
        removed = text[m.start():end]
        out.append("\n" * removed.count("\n"))   # keep line numbers stable
        pos = end
    out.append(text[pos:])
    text = "".join(out)

    # pass 2: replace kernel launches with loud no-ops
    out = []
    pos = 0
    mask = code_mask(text)
    for m in re.finditer(r"[A-Za-z_][A-Za-z_0-9]*\s*<<<", text):
        if m.start() < pos or not mask[m.start()]:
            continue
        close = text.index(">>>", m.end())
        paren = text.index("(", close + 3)
        while not mask[paren]:
            paren = text.index("(", paren + 1)
        end = _match_forward(text, mask, paren, "(", ")")
        out.append(text[pos:m.start()])
        removed = text[m.start():end]
        out.append("(abort(),(void)0)")
        out.append("\n" * removed.count("\n"))
        pos = end
    out.append(text[pos:])
    return "".join(out)


def main():
    src, dst = sys.argv[1], sys.argv[2]
    with open(src, "r", encoding="utf-8", errors="replace") as f:
        text = f.read()
    text = strip_cuda(text)
    with open(dst, "w", encoding="utf-8") as f:
        f.write('#include "cuda_stub.h"  /* [strip_cuda] */\n')
        f.write('#line 1 "%s"\n' % src)
        f.write(text)


if __name__ == "__main__":
    main()
