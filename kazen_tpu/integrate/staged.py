"""Host-staged wavefront driver: later bounces run on a narrowed slice.

The scan driver in path_mis.py runs every bounce at the full lane width,
so each bounce pays the full-width permute and masked shade stage even
after Russian roulette has killed most lanes.

This driver exploits an invariant the ordered wavefront already
maintains: the per-bounce permute key carries an alive-first tier bit
(path_mis._bounce_ordered), so after bounce k the still-alive lanes
occupy a contiguous prefix of length sum(alive) -- every lane that can
do ANY work in bounce k+1 (shade, NEE shadow ray, path ray, background
on miss) is inside that prefix; the suffix lanes are finished and their
state is final. So the host reads the single scalar alive count between
bounces and dispatches bounce k+1 compiled at the smallest menu width
that covers the prefix. The suffix is concatenated back untouched.

Exactness: images equal the scan driver's to float-ulp level
(test_staged; the two drivers compile the same bounce ops in different
XLA programs, which may reassociate/fuse differently). Slicing
only removes lanes that are provably inert -- dead lanes' stream draws
never influence any live lane (per-lane pcg streams), so the only
observable difference is the returned stream state of finished lanes,
which no caller consumes (render passes re-seed per sample index; the
reference's per-pixel loop likewise stops consuming once terminated,
integrator.cpp:195-338).

Cost: one device->host scalar sync per bounce against the work the
narrowing saves. Whether that pays on the GPU is not measured yet.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import path_mis


def _default_widths(n):
    """Width menu: full width + powers of two down to max(1024, n/32).
    Each distinct width compiles its own bounce program; the persistent
    compilation cache amortizes that across runs."""
    ws = [n]
    w = 1 << max((n - 1).bit_length() - 1, 0)
    while w >= 1024 and w >= n // 32:
        if w < n:
            ws.append(w)
        w >>= 1
    return ws


def _slice_state(st, n, m):
    def f(x):
        if getattr(x, "ndim", 0) == 0:
            return x
        if x.ndim >= 1 and x.shape[0] == n:
            return x[:m]
        if x.ndim == 2 and x.shape[-1] == n:
            return x[..., :m]
        return x

    return jax.tree_util.tree_map(f, st)


def _concat_state(new_head, old, n, m):
    """Full-width state = updated prefix + untouched suffix. Scalar
    leaves (the ray counter) come from the updated head."""

    def f(a, b):
        if getattr(a, "ndim", 0) == 0:
            return a
        if a.ndim >= 1 and a.shape[0] == m:
            return jnp.concatenate([a, b[m:]], 0) if m < n else a
        if a.ndim == 2 and a.shape[-1] == m:
            return jnp.concatenate([a, b[..., m:]], -1) if m < n else a
        return a

    return jax.tree_util.tree_map(f, new_head, old)


class StagedWavefront:
    """Per-(static, lane-width) driver. Build once, call run() per pass.

    init_fn(scene, *args) must return (state, *extras) where state is the
    path_mis._OState from path_mis.wavefront_init (callers fold their own
    stream/camera setup into it so XLA fuses the head);
    finish_fn(scene, state, *extras) produces the caller's outputs from
    the final full-width state (e.g. path_mis.wavefront_finish + splat).
    Both are jitted here.
    """

    def __init__(self, static, n, init_fn, finish_fn):
        self.static = static
        self.n = n
        self._init = jax.jit(init_fn)
        self._finish = jax.jit(finish_fn)
        self._bodies = {}
        self.widths = _default_widths(n)

    def _body(self, m, rr):
        """Jitted bounce at width m: takes and returns the FULL-width
        state; the prefix slice and suffix concat live inside the program
        instead of as ~40 small host-side dispatches per bounce."""
        key = (m, rr)
        fn = self._bodies.get(key)
        if fn is None:
            static, n = self.static, self.n

            def body(scene, spec, st_full):
                st = (
                    _slice_state(st_full, n, m) if m < n else st_full
                )
                st = path_mis._bounce_ordered(
                    scene, static, spec, st, draw_rr=rr
                )
                out = _concat_state(st, st_full, n, m)
                return out, jnp.sum(st.alive.astype(jnp.int32))

            fn = jax.jit(body, static_argnames=("spec",))
            self._bodies[key] = fn
        return fn

    def _pick(self, count):
        for w in reversed(self.widths):
            if w >= count:
                return w
        return self.n

    def run(self, scene, spec, *args, widths=None):
        """One pass. Two modes:

        widths=None (sync mode): the host reads the scalar alive count
        after each bounce and picks the next width -- always exact, one
        ~RPC-latency sync per bounce. Returns (out, record).

        widths=[...] (pipelined mode): use the given per-bounce width
        schedule (e.g. record.plan() from a previous pass) with NO
        per-bounce syncs; the alive counts come back as device scalars in
        the record and the caller MUST check record.ok() before trusting
        the output -- a pass whose live prefix outgrew the schedule must
        be rerun in sync mode. widths[0] must equal the full lane width.
        """
        n = self.n
        # The alive-first prefix invariant only holds when _bounce_ordered
        # actually permutes (BVH scenes); otherwise run every
        # bounce at full width -- still correct, no narrowing.
        narrow = path_mis._ordering_useful(scene)
        state, *extras = self._init(scene, *args)
        count = n
        depth = self.static.max_depth
        used, counts = [], []
        if widths is not None and (not narrow or widths[0] != n):
            widths = None if not narrow else [n] + list(widths[1:])
        for k in range(depth):
            if widths is None:
                if count == 0:
                    break
                m = self._pick(count) if narrow else n
            else:
                if k >= len(widths):
                    break
                m = widths[k]
            state, cnt = self._body(m, k >= 3)(scene, spec, state)
            used.append(m)
            counts.append(cnt)
            # sync mode: the scalar alive count picks the next width.
            # Skipped on the last bounce (nothing left to dispatch) and
            # when not narrowing (the count would go unused).
            if widths is None and narrow and k + 1 < depth:
                count = int(cnt)
                counts[-1] = count
        out = self._finish(scene, state, *extras)
        return out, PassRecord(self, used, counts, depth)


class PassRecord:
    """Widths used + alive counts of one staged pass."""

    def __init__(self, sw, widths, counts, depth):
        self._sw = sw
        self.widths = widths
        self.counts = counts
        self.depth = depth

    def _ints(self):
        return [int(c) for c in self.counts]

    def ok(self):
        """Exactness check for a pipelined pass: every bounce's width must
        have covered the live prefix entering it (count after bounce k-1),
        and an early-truncated schedule must have ended with zero live
        lanes. Sync-mode passes satisfy this by construction. Syncs."""
        cs = self._ints()
        for k in range(1, len(self.widths)):
            if self.widths[k] < cs[k - 1]:
                return False
        if len(self.widths) < self.depth and cs and cs[-1] > 0:
            return False
        return True

    def plan(self, margin=1.25):
        """Width schedule for a future pass of similar content: each
        bounce gets the smallest menu width covering margin * the count
        that entered it here (counts vary a little pass-to-pass from
        sampler noise). Bounces this pass never reached get the smallest
        menu width (they were dead; validation catches a revival)."""
        cs = self._ints()
        n = self._sw.n
        ws = [n]
        for k in range(1, self.depth):
            c = cs[k - 1] if k - 1 < len(cs) else 0
            if c == 0:
                break
            ws.append(self._sw._pick(min(n, int(c * margin))))
        return ws
