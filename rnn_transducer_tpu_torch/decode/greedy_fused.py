"""Greedy RNN-T decoding in one launch (PyTorch port of
`rnn_transducer_tpu/decode/greedy_pallas.py`).

The whole greedy loop of every utterance runs inside one kernel launch,
`csrc/greedy_fused.cu` (K9, replacing `greedy_decode_fused`'s Pallas
kernel), with no host sync per step; the lock-step decoder
(`decode/greedy.py`) syncs the host once per step. The encoder side of the
joint, f = enc_out @ enc_proj + b, is one matmul before the loop.

On the card a call is two launches. `greedy_pack_kernel` writes the f32
weights block-major into a scratch (`pack_reference` is its plain
version): for each block r of a cluster its gate columns of [W_ih; W_hh],
its W_pred columns and its W_out columns, each one contiguous run. Then
`greedy_cluster_kernel` decodes each utterance on one thread-block cluster
of C blocks, on the plan of `cluster_plan`: which vocab columns, LSTM
units and joint units a block owns, whether its W_out and W_pred slices
stay resident in shared memory or stream through a ring of TMA bulk
copies, the ring's depth and the shared bytes. The blocks exchange the
argmax candidates, h and g through distributed shared memory.

Dtypes follow the JAX kernel: the activations (embedding rows, h, z) are
rounded to the compute dtype, the weights stay f32 (`jnp.dot(bf16, f32)`
promotes to f32), so the products are `_act_dot`, not the port's `_dot`,
which rounds both operands.

`greedy_fused_tokens` launches the kernels for CUDA tensors and runs
`greedy_fused_tokens_reference` for CPU tensors; it never falls back from
one to the other. `LAUNCHES` counts the calls that launched them.
Outputs carry tokens and lengths only (no confidences or timestamps), so
the serving engine keeps the lock-step decoder.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import torch

from rnn_transducer_tpu_torch.models import transducer as m
from rnn_transducer_tpu_torch.models.config import TransducerConfig
from rnn_transducer_tpu_torch.ops.lstm import _dot
from rnn_transducer_tpu_torch.ops.quant import maybe_dequant_tree
from rnn_transducer_tpu_torch.utils import build

LANE = 128
LAUNCHES = 0  # calls that launched the pack and the cluster kernel
_launches_lock = threading.Lock()

# csrc/greedy_fused.cu's constants and the H100's opt-in shared memory a
# block.
THREADS = 256
MAX_CLUSTER = 16
MAX_SLOTS = 8
SMEM_BYTES = 232_448
SLOT_BYTES = 32_768  # a ring slot, unless 4 rows of a segment are longer
# W_pred's slice stays resident only if the ring keeps this many slots:
# it is read once an emission, the ring on every emission's gate columns.
FULL_RING_SLOTS = 4


def _r16(n: int) -> int:
    return (n + 15) // 16 * 16


def swizzle(n: int, groups: int) -> int:
    """The XOR that places group g (4 rows) of column n of a chunk with
    `groups` groups a column at position g ^ swizzle(n, groups), so that 8
    threads reading the same group of 8 neighbouring columns with 16-byte
    loads meet 8 distinct bank quads (csrc/greedy_fused.cu `swz`)."""
    if groups >= 8:
        return n & 7
    return {4: (n >> 1) & 3, 2: (n >> 2) & 1}.get(groups, 0)  # 1: none


@dataclasses.dataclass(frozen=True)
class Segment:
    """A block's slice of one weight matrix, stored column by column in
    chunks of `chunk` rows: chunk c holds, for each of `cols` columns, its
    rows c*chunk .. c*chunk + chunk - 1 (zero past `rows`) as groups of 4,
    group g at position g ^ swizzle(n, chunk // 4)."""

    rows: int
    cols: int
    chunk: int

    @property
    def chunks(self) -> int:
        return -(-self.rows // self.chunk)

    @property
    def floats(self) -> int:
        return self.chunks * self.cols * self.chunk


def _chunk_ok(R: int) -> bool:
    """Whether a chunk of R rows holds whole groups of 4 that the swizzle
    permutes within a column (R / 4 of 1, 2, 4 or a multiple of 8)."""
    return R % 4 == 0 and (R // 4 in (1, 2, 4) or (R // 4) % 8 == 0)


def _chunk_rows(rows: int, cols: int, target: int) -> int:
    """Rows a streamed chunk of a segment: the most of 4, 8, 16 or a
    multiple of 32 (up to `rows`) whose chunk fits `target` bytes, else
    4."""
    cands = [4, 8, 16] + list(range(32, rows + 1, 32))
    fits = [r for r in cands if cols * r * 4 <= target]
    return max(fits) if fits else 4


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """The layout of one `greedy_cluster_kernel` launch. Utterance b runs on
    one cluster of C blocks. Block r owns the LSTM units r*units .. (its
    gate columns n, H+n, 2H+n, 3H+n), the joint units r*joint_units .. and
    the vocab columns `vocab(r)`. Its run of the packed scratch
    (`pack_reference`) holds three segments: G, [W_ih; W_hh] side by side
    (max(E, H) rows, 8 units columns: W_ih's gate columns, then W_hh's), P,
    W_pred (H rows, joint_units columns) and O, W_out (J rows, vc
    columns). A resident segment is one chunk of all its rows."""

    E: int
    H: int
    J: int
    V: int
    C: int              # blocks a cluster
    units: int          # H / C
    joint_units: int    # J / C
    vc: int             # ceil(V / C)
    cand_warps: int     # warps a block that own vocab columns
    wo_resident: bool   # the W_out slice stays in shared memory
    wp_resident: bool   # the W_pred slice stays in shared memory
    f_slots: int        # 3: f rows prefetched two frames ahead and the
                        # next z formed a frame ahead; 0: f read from
                        # global memory (a shape with no room for them)
    g_chunk: int        # rows a chunk of G, P and O
    p_chunk: int
    o_chunk: int
    slots: int          # the ring's slots
    slot_bytes: int
    smem_bytes: int

    def vocab(self, r: int) -> range:
        """Block r's vocab columns (empty where V < C vc runs out)."""
        return range(min(r * self.vc, self.V), min((r + 1) * self.vc, self.V))

    @property
    def segments(self) -> tuple[Segment, Segment, Segment]:
        return (Segment(max(self.E, self.H), 8 * self.units, self.g_chunk),
                Segment(self.H, self.joint_units, self.p_chunk),
                Segment(self.J, self.vc, self.o_chunk))

    @property
    def block_floats(self) -> int:
        """Floats of a block's packed weights: G, P, O."""
        return sum(s.floats for s in self.segments)

    @property
    def packed_floats(self) -> int:
        return self.C * self.block_floats


def _smem(E, H, J, C, U, JU, vc, cw, wo_res, wp_res, fs, slots,
          slot_bytes) -> int:
    """Shared bytes of a block, as csrc/greedy_fused.cu `layout` lays them
    out: mbarriers, the utterance's row, the candidates' two arrays, z, e
    (or, with f rows, z's other buffer), g, fs f rows, two h buffers, c,
    the gate bias and sums, the joint units' sums and bias, the vocab
    columns' sums and bias, the resident slices, the ring."""
    return (_r16((7 + slots) * 8) + 16 + _r16(2 * C * cw * 8)
            + (2 + fs) * _r16(J * 4) + _r16(max(E, J if fs else 0) * 4)
            + 2 * _r16(H * 4) + _r16(U * 4) + _r16(16 * U) + _r16(32 * U)
            + 2 * _r16(JU * 4) + 2 * _r16(vc * 4)
            + (J * vc * 4 if wo_res else 0) + (H * JU * 4 if wp_res else 0)
            + slots * slot_bytes)


# The plans `cluster_plan` tries, in order: f rows prefetched or not,
# ring slots of this many bytes, then W_out's and W_pred's residency with
# the ring slots each needs beside it. Smaller slots and no f rows are for
# shapes that leave no room for more.
_TIERS = tuple((fs, target) for fs in (3, 0)
               for target in (SLOT_BYTES, 8192, 2048, 0))
_RESIDENCY = ((True, True, FULL_RING_SLOTS), (True, False, 2),
              (False, False, 2), (False, False, 1))


@functools.lru_cache(maxsize=None)
def cluster_plan(E: int, H: int, J: int, V: int) -> ClusterPlan:
    """The cluster plan of K9 at embedding E, predictor H, joint J and
    vocab V (E, H, J multiples of 128, as `supported` asks): C = 16 blocks
    an utterance; f rows prefetched and SLOT_BYTES ring slots; W_out's
    slice resident where it fits beside a ring of two slots, W_pred's
    where the ring then keeps FULL_RING_SLOTS; the ring as deep as the
    rest allows, up to MAX_SLOTS. Where that leaves no room, smaller slots,
    then no f rows in shared memory (`_TIERS`). Raises ValueError for a
    shape whose state no block can hold."""
    C = MAX_CLUSTER
    if min(E, H, J, V) < 1 or E % 4 or H % C or J % C:
        raise ValueError(f"greedy_fused: no cluster plan for E={E}, H={H}, "
                         f"J={J}, V={V}: H and J must be multiples of {C}, "
                         "E of 4")
    U, JU, vc = H // C, J // C, -(-V // C)
    cw = min(THREADS // 32, -(-vc // 32))
    least = None
    for fs, target in _TIERS:
        g_chunk = _chunk_rows(max(E, H), 8 * U, target)
        for wo_res, wp_res, min_slots in _RESIDENCY:
            if (wo_res and not _chunk_ok(J)) or (wp_res and not _chunk_ok(H)):
                continue  # one chunk of all rows must swizzle too
            p_chunk = H if wp_res else _chunk_rows(H, JU, target)
            o_chunk = J if wo_res else _chunk_rows(J, vc, target)
            slot = max([8 * U * g_chunk * 4]
                       + ([] if wp_res else [JU * p_chunk * 4])
                       + ([] if wo_res else [vc * o_chunk * 4]))
            smem = [_smem(E, H, J, C, U, JU, vc, cw, wo_res, wp_res, fs, n,
                          slot) for n in range(MAX_SLOTS + 1)]
            least = smem[1] if least is None else min(least, smem[1])
            slots = max((n for n in range(1, MAX_SLOTS + 1)
                         if smem[n] <= SMEM_BYTES), default=0)
            if slots >= min_slots:
                return ClusterPlan(E, H, J, V, C, U, JU, vc, cw, wo_res,
                                   wp_res, fs, g_chunk, p_chunk, o_chunk,
                                   slots, slot, smem[slots])
    raise ValueError(f"greedy_fused: no block holds the state of E={E}, "
                     f"H={H}, J={J}, V={V} (at least {least} shared bytes; "
                     f"the card offers {SMEM_BYTES})")


def _to_chunks(m: torch.Tensor, seg: Segment) -> torch.Tensor:
    """The (rows, cols) matrix m in the segment's layout, flat."""
    rows = seg.chunks * seg.chunk
    m = torch.cat([m, m.new_zeros(rows - m.shape[0], m.shape[1])])
    groups = seg.chunk // 4
    # (chunk, group, 4, col) -> (chunk, col, group, 4), then swizzled
    t = m.view(seg.chunks, groups, 4, seg.cols).permute(0, 3, 1, 2)
    idx = torch.tensor([[p ^ swizzle(n, groups) for p in range(groups)]
                        for n in range(seg.cols)], device=m.device)
    idx = idx.view(1, seg.cols, groups, 1).expand(seg.chunks, -1, -1, 4)
    return torch.gather(t, 2, idx).reshape(-1)


def _from_chunks(flat: torch.Tensor, seg: Segment) -> torch.Tensor:
    """The inverse of `_to_chunks`: the segment's (rows, cols) matrix."""
    groups = seg.chunk // 4
    t = flat.view(seg.chunks, seg.cols, groups, 4)
    idx = torch.tensor([[p ^ swizzle(n, groups) for p in range(groups)]
                        for n in range(seg.cols)], device=flat.device)
    idx = idx.view(1, seg.cols, groups, 1).expand(seg.chunks, -1, -1, 4)
    t = torch.gather(t, 2, idx)  # the swizzle is its own inverse
    return t.permute(0, 2, 3, 1).reshape(-1, seg.cols)[:seg.rows]


def pack_reference(weights, plan: ClusterPlan) -> torch.Tensor:
    """The plain version of `greedy_pack_kernel`: the packed scratch
    (plan.packed_floats,) f32, block r's run holding its segments G, P
    and O (`ClusterPlan`, `Segment`): W_ih's and W_hh's gate columns a*H +
    r*units + n (a = i, f, g, o), W_pred's columns r*joint_units .., W_out's
    columns vocab(r), zero past each matrix."""
    _, w_ih, w_hh, _, wp, _, wo, _ = weights
    E, H, J = plan.E, plan.H, plan.J
    C, U, JU, vc = plan.C, plan.units, plan.joint_units, plan.vc
    seg_g, seg_p, seg_o = plan.segments
    runs = []
    for r in range(C):
        cols = torch.cat([torch.arange(a * H + r * U, a * H + (r + 1) * U)
                          for a in range(4)]).to(w_ih.device)
        g = torch.zeros(seg_g.rows, 8 * U, dtype=torch.float32,
                        device=w_ih.device)
        g[:E, :4 * U] = w_ih[:, cols]
        g[:H, 4 * U:] = w_hh[:, cols]
        o = torch.zeros(J, vc, dtype=torch.float32, device=wo.device)
        vs = plan.vocab(r)
        o[:, :len(vs)] = wo[:, vs.start:vs.stop]
        runs += [_to_chunks(g, seg_g),
                 _to_chunks(wp[:, r * JU:(r + 1) * JU].float(), seg_p),
                 _to_chunks(o, seg_o)]
    return torch.cat(runs)


def unpack_reference(packed: torch.Tensor, plan: ClusterPlan):
    """W_ih, W_hh, W_pred and W_out back from a packed scratch: the
    inverse of `pack_reference`."""
    E, H, J, V = plan.E, plan.H, plan.J, plan.V
    C, U, JU = plan.C, plan.units, plan.joint_units
    seg_g, seg_p, seg_o = plan.segments
    w_ih = packed.new_empty(E, 4 * H)
    w_hh = packed.new_empty(H, 4 * H)
    wp = packed.new_empty(H, J)
    wo = packed.new_empty(J, V)
    for r, run in enumerate(packed.view(C, plan.block_floats)):
        g = _from_chunks(run[:seg_g.floats], seg_g)
        p = _from_chunks(run[seg_g.floats:seg_g.floats + seg_p.floats],
                         seg_p)
        o = _from_chunks(run[seg_g.floats + seg_p.floats:], seg_o)
        for a in range(4):
            cs = slice(a * H + r * U, a * H + (r + 1) * U)
            w_ih[:, cs] = g[:E, a * U:(a + 1) * U]
            w_hh[:, cs] = g[:H, 4 * U + a * U:4 * U + (a + 1) * U]
        wp[:, r * JU:(r + 1) * JU] = p
        vs = plan.vocab(r)
        wo[:, vs.start:vs.stop] = o[:, :len(vs)]
    return w_ih, w_hh, wp, wo


def device_clusters(plan: ClusterPlan, device) -> int:
    """Clusters of `plan` that the CUDA card `device` holds at once
    (cudaOccupancyMaxActiveClusters). `greedy_cluster` makes the same
    query on every launch and refuses a plan the card holds no cluster
    of."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    fn = build.load_library()
    n = ctypes.c_int()
    build.check_launch(fn, fn.greedy_cluster_occupancy(
        plan.C, plan.smem_bytes, index, ctypes.byref(n)),
        "greedy_cluster_occupancy")
    return n.value


def pack_weights(weights, plan: ClusterPlan) -> torch.Tensor:
    """The packed scratch of `plan`: `greedy_pack_kernel` on a CUDA tensor,
    `pack_reference` on a CPU one."""
    dev = weights[1].device
    if dev.type == "cpu":
        return pack_reference(weights, plan)
    if dev.type != "cuda":
        raise ValueError(f"no fused greedy decode for device {dev}")
    _, w_ih, w_hh, _, wp, _, wo, _ = weights
    packed = torch.empty(plan.packed_floats, dtype=torch.float32, device=dev)
    fn = build.load_library()
    err = fn.greedy_pack(w_ih.data_ptr(), w_hh.data_ptr(), wp.data_ptr(),
                         wo.data_ptr(), packed.data_ptr(), plan.E, plan.H,
                         plan.J, plan.V, plan.C, plan.g_chunk,
                         plan.p_chunk, plan.o_chunk, *build.stream_args(dev))
    build.check_launch(fn, err, "greedy_pack")
    return packed


def supported(cfg: TransducerConfig) -> bool:
    """The JAX kernel's predicate, one predictor layer and E, H and J
    multiples of 128, and three more conditions that JAX's predicate
    (greedy_pallas.py:33-37) does not ask: an LSTM predictor (the kernel
    steps w_ih and w_hh, which a stateless predictor has not), no
    duration family (the kernel advances one frame a blank and has no
    duration head; JAX's engine never calls its kernel on one), and no
    MoE joint (the kernel's joint has no experts, so it would decode the
    model without them)."""
    return (cfg.pred_type == "lstm" and cfg.pred_layers == 1
            and not cfg.big_blank_durations and not cfg.tdt_durations
            and cfg.joint_experts == 0
            and cfg.embed_dim % LANE == 0
            and cfg.pred_hidden % LANE == 0
            and cfg.joint_dim % LANE == 0)


def _act_dot(x: torch.Tensor, w: torch.Tensor,
             cdtype: torch.dtype) -> torch.Tensor:
    """x @ w with x rounded to `cdtype` and w kept f32, an f32 result."""
    return torch.matmul(x.to(cdtype).float(), w.float())


def _check(f, lens, weights, max_symbols: int, blank: int):
    if f.dim() != 3:
        raise ValueError(f"f must be (B, T, J); got {tuple(f.shape)}")
    B, _, J = f.shape
    embed, w_ih, w_hh, b, wp, bp, wo, bo = weights
    V, E = embed.shape
    H = w_hh.shape[0]
    shapes = {"lens": (lens, (B,)), "embed": (embed, (V, E)),
              "w_ih": (w_ih, (E, 4 * H)), "w_hh": (w_hh, (H, 4 * H)),
              "b": (b, (4 * H,)), "wp": (wp, (H, J)), "bp": (bp, (J,)),
              "wo": (wo, (J, V)), "bo": (bo, (V,))}
    for name, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(a.shape)}")
        want = torch.int32 if name == "lens" else torch.float32
        if a.dtype != want:
            raise TypeError(f"{name} must be {want}; got {a.dtype}")
    if f.dtype != torch.float32:
        raise TypeError(f"f must be float32; got {f.dtype}")
    if max_symbols < 1 or not 0 <= blank < V:
        raise ValueError(f"max_symbols {max_symbols} or blank {blank} out of "
                         "range")
    named = [("f", f), *((n, a) for n, (a, _) in shapes.items())]
    if len({a.device for _, a in named}) != 1:
        raise ValueError("inputs on different devices")
    for name, a in named:
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def greedy_fused_tokens(f, lens, weights, max_symbols: int, blank: int,
                        cdtype: torch.dtype):
    """tokens (B, max_symbols) int32, blank-padded, and steps (B,) int32,
    the loop iterations each utterance ran.

    f (B, T, J) f32 is the encoder side of the joint, lens (B,) int32 the
    valid frames; weights = (embed (V, E), w_ih (E, 4H), w_hh (H, 4H),
    b (4H,), pred_proj w (H, J), pred_proj b (J,), out w (J, V),
    out b (V,)), all f32.
    """
    global LAUNCHES
    _check(f, lens, weights, max_symbols, blank)
    dev = f.device
    if dev.type == "cpu":
        return greedy_fused_tokens_reference(f, lens, weights, max_symbols,
                                             blank, cdtype)
    if dev.type != "cuda":
        raise ValueError(f"no fused greedy decode for device {dev}")
    J = f.shape[2]
    E, H, V = weights[0].shape[1], weights[2].shape[0], weights[0].shape[0]
    if f.data_ptr() % 16:
        raise ValueError("f must start on a 16-byte boundary (TMA rows)")
    plan = cluster_plan(E, H, J, V)
    packed = pack_weights(weights, plan)
    tokens, steps = launch_cluster(build.load_library(), f, lens, weights,
                                   packed, plan, max_symbols, blank, cdtype)
    with _launches_lock:
        LAUNCHES += 1
    return tokens, steps


def launch_cluster(fn, f, lens, weights, packed, plan: ClusterPlan,
                   max_symbols: int, blank: int, cdtype: torch.dtype):
    """`greedy_cluster_kernel` from the library `fn` on the CUDA tensors of
    `greedy_fused_tokens` and the packed scratch of `plan`: tokens and
    steps."""
    B, T, J = f.shape
    dev = f.device
    tokens = torch.empty((B, max_symbols), dtype=torch.int32, device=dev)
    steps = torch.empty((B,), dtype=torch.int32, device=dev)
    err = fn.greedy_cluster(
        f.data_ptr(), lens.data_ptr(), *(w.data_ptr() for w in weights),
        packed.data_ptr(), tokens.data_ptr(), steps.data_ptr(), B, T,
        plan.E, plan.H, J, plan.V, max_symbols, blank,
        int(cdtype == torch.bfloat16), plan.C, int(plan.wo_resident),
        int(plan.wp_resident), plan.f_slots, plan.g_chunk, plan.p_chunk,
        plan.o_chunk, plan.slots, plan.slot_bytes, plan.smem_bytes,
        *build.stream_args(dev))
    build.check_launch(fn, err, "greedy_cluster")
    return tokens, steps


def greedy_fused_tokens_reference(f, lens, weights, max_symbols: int,
                                  blank: int, cdtype: torch.dtype):
    """The plain version: the JAX kernel's loop for all utterances at once,
    the prediction network computed every step and selected where a row
    emits, until every row is done."""
    _check(f, lens, weights, max_symbols, blank)
    embed, w_ih, w_hh, b, wp, bp, wo, bo = weights
    B, _, J = f.shape
    H = w_hh.shape[0]
    dev = f.device
    rows = torch.arange(B, device=dev)

    def pred_step(k, h, c):
        gates = (_act_dot(embed[k], w_ih, cdtype) + _act_dot(h, w_hh, cdtype)
                 + b)
        i, fg, gg, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(fg) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        return _act_dot(h, wp, cdtype) + bp, h, c

    zeros = torch.zeros((B, H), dtype=torch.float32, device=dev)
    g, h, c = pred_step(torch.full((B,), blank, device=dev), zeros, zeros)
    lens = lens.long()
    t = torch.zeros(B, dtype=torch.long, device=dev)
    u = torch.zeros(B, dtype=torch.long, device=dev)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    tokens = torch.full((B, max_symbols), blank, dtype=torch.int32,
                        device=dev)
    done = (t >= lens) | (u >= max_symbols)
    while not bool(done.all()):
        t_safe = torch.minimum(t, (lens - 1).clamp(min=0))
        z = torch.tanh(f[rows, t_safe] + g)
        k = torch.argmax(_act_dot(z, wo, cdtype) + bo, dim=-1)
        emit = (k != blank) & ~done
        tokens[rows[emit], u[emit]] = k[emit].to(torch.int32)
        g2, h2, c2 = pred_step(torch.where(emit, k, blank), h, c)
        e = emit[:, None]
        g, h, c = (torch.where(e, g2, g), torch.where(e, h2, h),
                   torch.where(e, c2, c))
        steps += (~done).to(torch.int32)
        u = u + emit.long()
        t = t + ((k == blank) & ~done).long()
        done = (t >= lens) | (u >= max_symbols)
    return tokens, steps


def greedy_decode_fused(params, cfg: TransducerConfig, enc_out, enc_lens,
                        max_symbols: int = 200):
    """Greedy decode of a batch of encoded utterances, one program each.

    Returns tokens (B, max_symbols) int32, blank-padded, and lengths (B,)
    int32, the count of non-blank tokens: the first two results of
    `greedy.greedy_decode`. Raises ValueError for a config outside
    `supported()`; it never falls back to the lock-step decoder.
    """
    f, lens, weights = fused_inputs(params, cfg, enc_out, enc_lens)
    tokens, _ = greedy_fused_tokens(f, lens, weights, max_symbols, cfg.blank,
                                    cfg.cdtype)
    lengths = (tokens != cfg.blank).sum(dim=1, dtype=torch.int32)
    return tokens, lengths


def fused_inputs(params, cfg: TransducerConfig, enc_out, enc_lens):
    """The arguments of `greedy_fused_tokens` for an encoded batch: f (the
    encoder side of the joint, one matmul), int32 lengths and the f32
    weights. Raises ValueError for a config outside `supported()`."""
    _check_fused(cfg)
    params = maybe_dequant_tree(params)  # int8 serving params
    jp = params["joint"]
    f = (_dot(enc_out, jp["enc_proj"]["w"], cfg.cdtype)
         + jp["enc_proj"]["b"].float()).contiguous()  # (B, T, J)
    layer = params["predictor"][0]
    weights = tuple(w.float().contiguous() for w in (
        params["embed"], layer["w_ih"], layer["w_hh"], layer["b"],
        jp["pred_proj"]["w"], jp["pred_proj"]["b"], jp["out"]["w"],
        jp["out"]["b"]))
    lens = enc_lens.to(device=f.device, dtype=torch.int32).contiguous()
    return f, lens, weights


def _check_fused(cfg: TransducerConfig) -> None:
    m.check_supported(cfg)
    if not supported(cfg):
        raise ValueError("greedy_decode_fused needs an LSTM predictor of "
                         "one layer, E, H, J multiples of 128, no duration "
                         "family and no MoE joint; use decode.greedy")


def recognize_greedy_fused(params, cfg: TransducerConfig, feats, feat_lens,
                           max_symbols: int = 200):
    """Features -> (tokens, lengths) through `encode` and the fused loop;
    a config outside `supported()` is refused before the encoder runs."""
    _check_fused(cfg)
    enc_out, enc_lens = m.encode(params, cfg, feats, feat_lens)
    return greedy_decode_fused(params, cfg, enc_out, enc_lens, max_symbols)
