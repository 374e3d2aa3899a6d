"""Randomized Hadamard rotations, block-diagonal or full-size.

The randomized Hadamard of order n is ``Q = diag(signs) @ H_n / sqrt(n)``
in float64.  ``H_n`` is Sylvester's for powers of two, otherwise a Paley
base (types I and II, over GF(q) for prime powers q) times Sylvester
doubling, as the JAX package's ``ops/hadamard.py`` builds it: the widths of
VAR-d30 (1920 = 4 x 480, Paley I with q = 479) and VAR-d36 (2304 = 64 x
36, Paley II with q = 17) need the Paley bases.

The signs are ``torch.randint(0, 2, (n,)) * 2 - 1`` after seeding torch's
CPU generator with the rotation seed, the draw of the JAX package's
``torch_signs``; the port draws them from a ``torch.Generator`` of its own
(the same stream) and never touches the global RNG.  The seed-42 / 128
table stays frozen.

Every 128-block of the block-diagonal rotation is the same matrix, so the
online activation rotation ``x @ block_diag(Q_b, ..., Q_b)`` is one
``[..., C/128, 128] @ [128, 128]`` matmul.
"""
from __future__ import annotations

from functools import lru_cache
from itertools import product

import numpy as np
import torch

# torch.manual_seed(42); torch.randint(0, 2, (128,)) * 2 - 1   (frozen)
_SEED42_SIGNS_128 = np.array([
    -1, 1, -1, -1, -1, 1, -1, -1, -1, 1, -1, -1, -1, -1, 1, -1,
    1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
    1, 1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, 1, 1, 1, -1,
    1, 1, -1, 1, -1, 1, -1, 1, 1, -1, -1, -1, -1, -1, -1, -1,
    -1, 1, 1, -1, 1, 1, 1, 1, -1, 1, -1, 1, 1, 1, -1, 1,
    -1, 1, -1, 1, -1, -1, 1, -1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, -1, -1, 1, 1, 1, 1, 1, 1, 1, 1, -1, 1, -1,
    1, 1, -1, 1, -1, 1, 1, -1, 1, -1, 1, -1, -1, 1, 1, -1,
], dtype=np.float64)


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@lru_cache(maxsize=None)
def sylvester_hadamard(n: int) -> np.ndarray:
    """Unnormalized symmetric Hadamard matrix of power-of-two order."""
    if not is_pow2(n):
        raise ValueError(f"sylvester_hadamard needs a power of 2, got {n}")
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def _is_prime_power(q: int):
    """(p, k) with q = p^k for a prime p, else None."""
    for p in range(2, int(q ** 0.5) + 1):
        if q % p == 0:
            k = 0
            while q % p == 0:
                q //= p
                k += 1
            return (p, k) if q == 1 else None
    return (q, 1) if q > 1 else None


def _gf_elements_and_squares(p: int, k: int):
    """GF(p^k) as coefficient tuples over the first monic irreducible
    polynomial of degree k (in ``itertools.product`` order): (elements,
    index of each element, indices of the nonzero squares)."""
    def polmulmod(a, b, m):
        r = [0] * (2 * k)
        for i, ai in enumerate(a):
            if ai:
                for j, bj in enumerate(b):
                    r[i + j] = (r[i + j] + ai * bj) % p
        for i in range(len(r) - 1, k - 1, -1):
            c = r[i] % p
            if c:
                for j in range(k):
                    r[i - k + j] = (r[i - k + j] - c * m[j]) % p
                r[i] = 0
        return tuple(x % p for x in r[:k])

    def divides(cand, poly):
        d = len(cand) - 1
        rem = list(poly)
        for i in range(len(rem) - 1, d - 1, -1):
            c = rem[i] % p
            if c:
                for j in range(d + 1):
                    rem[i - d + j] = (rem[i - d + j] - c * cand[j]) % p
        return all(x % p == 0 for x in rem[:d])

    irr = None
    for coeffs in product(range(p), repeat=k):
        poly = list(coeffs) + [1]
        if not any(divides(list(lo) + [1], poly)
                   for d in range(1, k // 2 + 1)
                   for lo in product(range(p), repeat=d)):
            irr = list(coeffs)
            break
    if irr is None:
        raise ValueError(f"no irreducible polynomial of degree {k} over "
                         f"GF({p})")
    elems = [tuple(c) for c in product(range(p), repeat=k)]
    index = {e: i for i, e in enumerate(elems)}
    squares = {index[polmulmod(e, e, irr)] for e in elems if any(e)}
    return elems, index, squares


def _quadratic_character_matrix(q: int) -> np.ndarray:
    """chi(a - b) over GF(q): +1 for a nonzero square, -1 for a nonsquare,
    0 for zero."""
    p, k = _is_prime_power(q)
    if k == 1:
        chi = np.full(q, -1.0)
        chi[list({(x * x) % q for x in range(1, q)})] = 1.0
        chi[0] = 0.0
        idx = (np.arange(q)[:, None] - np.arange(q)[None, :]) % q
        return chi[idx]
    elems, index, squares = _gf_elements_and_squares(p, k)
    arr = np.array(elems)
    out = np.zeros((q, q))
    for i in range(q):
        diff = (arr[i] - arr) % p
        for j in range(q):
            d = tuple(int(v) for v in diff[j])
            if any(d):
                out[i, j] = 1.0 if index[d] in squares else -1.0
    return out


def paley_hadamard(n: int) -> np.ndarray:
    """Hadamard matrix of order n by Paley's constructions: type I for
    n = q + 1 (q a prime power, q % 4 == 3), type II for n = 2(q + 1)
    (q % 4 == 1)."""
    q = n - 1
    if _is_prime_power(q) and q % 4 == 3:
        # H = I + S, S = [[0, 1^T], [-1, Q]] skew (the Jacobsthal matrix Q
        # is skew-symmetric for q = 3 mod 4)
        h = np.ones((n, n))
        h[1:, 0] = -1.0
        h[1:, 1:] = _quadratic_character_matrix(q) + np.eye(q)
        return h
    if n % 2 == 0:
        q = n // 2 - 1
        if _is_prime_power(q) and q % 4 == 1:
            s = np.zeros((q + 1, q + 1))
            s[0, 1:] = 1.0
            s[1:, 0] = 1.0
            s[1:, 1:] = _quadratic_character_matrix(q)
            a = np.array([[1.0, 1.0], [1.0, -1.0]])
            b = np.array([[1.0, -1.0], [-1.0, -1.0]])
            return np.kron(s, a) + np.kron(np.eye(q + 1), b)
    raise ValueError(f"no Paley construction for order {n}")


@lru_cache(maxsize=None)
def hadamard_matrix(n: int) -> np.ndarray:
    """Hadamard matrix of order n: Sylvester's for a power of two, else
    the first Paley base n / 2^j (j = 0, 1, ...) times Sylvester's of order
    2^j."""
    if is_pow2(n):
        return sylvester_hadamard(n)
    two = 1
    while two <= n:
        if n % two == 0:
            try:
                base = paley_hadamard(n // two)
            except ValueError:
                base = None
            if base is not None:
                h = np.kron(sylvester_hadamard(two), base)
                if not np.array_equal(h @ h.T, n * np.eye(n)):
                    raise ArithmeticError(f"order {n}: H H^T != n I")
                return h
        two *= 2
    raise ValueError(f"no Hadamard construction available for order {n}")


def torch_signs(size: int, seed: int) -> np.ndarray:
    """``torch.randint(0, 2, (size,)) * 2 - 1`` from a CPU generator seeded
    with ``seed``, as float64 (the frozen table for size 128, seed 42)."""
    if size == 128 and seed == 42:
        return _SEED42_SIGNS_128.copy()
    gen = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 2, (size,), generator=gen) * 2 - 1).to(
        torch.float64).numpy()


def random_hadamard_matrix(size: int, seed: int = 42) -> np.ndarray:
    """``diag(signs) @ H / sqrt(n)`` in float64: an orthogonal randomized
    Hadamard of any order :func:`hadamard_matrix` builds."""
    s = torch_signs(size, seed)
    return (s[:, None] * hadamard_matrix(size)) / np.sqrt(size)


def block_hadamard_block(block_size: int = 128, seed: int = 42) -> np.ndarray:
    """The block Q_b shared by every block of the block-diagonal rotation."""
    return random_hadamard_matrix(block_size, seed)


def block_hadamard_matrix(total_size: int, block_size: int = 128,
                          seed: int = 42) -> np.ndarray:
    """The dense block-diagonal rotation (for tests and exports; the model
    applies it with :func:`apply_block_hadamard`)."""
    if total_size % block_size:
        raise ValueError("total_size must be divisible by block_size")
    q = block_hadamard_block(block_size, seed)
    out = np.zeros((total_size, total_size), dtype=np.float64)
    for i in range(0, total_size, block_size):
        out[i:i + block_size, i:i + block_size] = q
    return out


def apply_block_hadamard(x: torch.Tensor, q_block: torch.Tensor) -> torch.Tensor:
    """``x @ block_diag(Q_b, ..., Q_b)`` as one ``[..., C/b, b] @ [b, b]``
    matmul; ``x`` is ``[..., C]`` with ``C % b == 0``."""
    b = q_block.shape[0]
    xb = x.reshape(x.shape[:-1] + (x.shape[-1] // b, b))
    return (xb @ q_block.to(x.dtype)).reshape(x.shape)
