"""Streaming (chunked) inference for the Conformer encoder and recognizer.

Port of indic_cl_asr_tpu/models/streaming.py, in two halves.

**Windowed recomputation** (``StreamingEncoder``): a rolling mel window is
re-encoded through the model's own ``encode`` at every chunk and only the
newly determined encoder frames are emitted. With a causal-conv,
left-limited-attention config (``causal_conv=True``,
``att_context_size=(L, 0)``) an emitted frame's receptive field spans at
most ``n_layers * (L + k - 1)`` encoder frames to the left; when the window
covers that span plus a chunk, the streamed frames equal the offline
encoder's. A flash config runs the flash forward kernel (band ``(L, 0)``)
on every window.

**Cache-aware streaming** (``CacheAwareStreamer``): per-layer attention and
conv caches, O(chunk) work a step (the reference's cache_last_channel /
cache_last_time streaming). The step functions run the offline encoder's
own submodules, so there is one copy of the weights:

  * ``subsampling_step`` (the JAX ``ConvSubsamplingStep``): the x4
    subsampling time-VALID over the chunk and a 3-frame mel halo, the
    conv_0 row the offline path zero-pads (absolute index -1) zeroed;
  * ``attention_step`` (``RelPosSelfAttentionStep``): queries are the
    chunk's frames, keys and values span [cache | chunk]; score (t, j)
    takes the position embedding of distance A + t - j (a rectangular
    rel-shift), and a key is valid when it exists, is not in the query's
    future and lies within A frames to its left. Eager attention: the flash
    kernels take square blocks only;
  * ``conv_module_step`` (``ConvModuleStep``): the depthwise conv over
    [conv cache | chunk] with no padding (the causal conv's own padding is
    in its forward); BatchNorm (running statistics) or LayerNorm;
  * ``layer_step`` and ``encoder_step`` (``ConformerLayerStep``,
    ``CacheAwareEncoderStep``). The JAX package's ``_StackStep`` has no
    counterpart: the port has one module a layer, which models/convert.py
    fills from either JAX layout.

``StreamingASR`` joins ``CacheAwareStreamer`` with the greedy decode's
streaming continuation (ops/decoding.py ``rnnt_greedy_decode(carry=...,
t_offset=...)``), the plain batched decode on either device as in the JAX
package, so chunked recognition emits the offline greedy tokens on a causal
config.

The streamers put the model in eval mode and run under
``torch.inference_mode()``; control flow is on the host (chunk counters
are Python ints), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..ops.decoding import rnnt_greedy_decode
from .common import cast
from .conformer import ConformerConfig, sinusoids, subsampled_length


@dataclasses.dataclass
class StreamingConfig:
    chunk_mel: int = 64          # new mel frames consumed per step
    window_mel: int = 512        # rolling window re-encoded per step
    # subsampling halo: enc frame i needs mel up to 4i + 3 (two k3 s2 convs)
    right_halo_mel: int = 3

    def __post_init__(self):
        if self.chunk_mel % 4 or self.window_mel % 4:
            raise ValueError("chunk/window must be multiples of the subsampling factor")
        if self.window_mel % self.chunk_mel:
            raise ValueError("the window must be a multiple of the chunk")


def receptive_field_enc(cfg: ConformerConfig) -> int:
    """Left receptive field of one emitted frame, in encoder frames."""
    left_att = cfg.att_context_size[0] if cfg.att_context_size[0] >= 0 else 10**9
    return cfg.n_layers * (left_att + cfg.conv_kernel_size - 1)


@dataclasses.dataclass
class StreamState:
    mel_window: torch.Tensor  # [B, n_mels, W]
    consumed_mel: int = 0     # total mel frames fed so far
    emitted_enc: int = 0      # total encoder frames emitted so far


class StreamingEncoder:
    """Drives a model's offline encoder chunk by chunk:

        se = StreamingEncoder(model, StreamingConfig())
        state = se.init(batch_size)
        for chunk in mel_chunks:                 # [B, n_mels, chunk_mel]
            enc_window, start, n_new, state = se.step(state, chunk)
        enc_window, start, n_new, state = se.flush(state)
    """

    def __init__(self, model, scfg: StreamingConfig):
        if model.cfg.encoder.att_context_size[1] != 0:
            # -1 means UNLIMITED right context: the emission schedule's
            # subsampling-halo-only rule would silently diverge from the
            # offline encoder
            raise ValueError("streaming needs zero right attention context")
        self.model = model.eval()
        self.cfg = model.cfg
        self.scfg = scfg

    def init(self, batch_size: int, n_mels: int | None = None) -> StreamState:
        n_mels = n_mels or self.cfg.encoder.feat_in
        return StreamState(mel_window=torch.zeros(
            (batch_size, n_mels, self.scfg.window_mel), device=self.model.device))

    def step(self, state: StreamState, chunk: torch.Tensor):
        """chunk [B, n_mels, chunk_mel] -> (enc_window [B, T_w, d],
        start_local, n_new, new state); the newly determined frames are
        ``enc_window[:, start_local:start_local + n_new]``."""
        C, W = self.scfg.chunk_mel, self.scfg.window_mel
        if chunk.shape[-1] != C:
            raise ValueError(f"a chunk holds {C} mel frames, got {chunk.shape[-1]}")
        chunk = chunk.to(self.model.device, torch.float32)
        if state.consumed_mel < W:
            # fill phase: the window is the utterance prefix, left-aligned
            pos = state.consumed_mel
            window = state.mel_window.clone()
            window[:, :, pos:pos + C] = chunk
        else:
            window = torch.cat([state.mel_window[:, :, C:], chunk], dim=-1)
        return self._emit(window, state.consumed_mel + C, state.emitted_enc, final=False)

    def flush(self, state: StreamState):
        """Emit the frames that were waiting on the right subsampling halo."""
        return self._emit(state.mel_window, state.consumed_mel, state.emitted_enc,
                          final=True)

    def _emit(self, window, consumed: int, emitted: int, final: bool):
        W = self.scfg.window_mel
        B = window.shape[0]
        valid = min(consumed, W)
        with torch.inference_mode():
            f, _ = self.model.encode(
                window, torch.full((B,), valid, dtype=torch.int32, device=window.device))
        if final:
            determined = subsampled_length(consumed, self.cfg.encoder)
        else:
            # without right attention context, enc frame i is final once
            # mel frame 4i + halo exists
            determined = max((consumed - self.scfg.right_halo_mel) // 4 + 1, 0)
        n_new = max(determined - emitted, 0)
        win_offset = max(consumed - W, 0) // 4  # absolute enc index of frame 0
        new_state = StreamState(mel_window=window, consumed_mel=consumed,
                                emitted_enc=emitted + n_new)
        return f, emitted - win_offset, n_new, new_state


def stream_full_utterance(se: StreamingEncoder, mel: torch.Tensor) -> torch.Tensor:
    """A whole [B, n_mels, T] mel through the windowed streamer -> the
    emitted frames [B, ceil(T/4), d], concatenated."""
    B, n_mels, T = mel.shape
    C = se.scfg.chunk_mel
    mel = F.pad(mel, (0, -T % C))
    state = se.init(B, n_mels)
    outs = []
    for c0 in range(0, mel.shape[-1], C):
        f, start, n_new, state = se.step(state, mel[:, :, c0:c0 + C])
        outs.append(f[:, start:start + n_new])
    f, start, n_new, state = se.flush(state)
    outs.append(f[:, start:start + n_new])
    # drop frames computed over the chunk-alignment zero padding
    return torch.cat(outs, dim=1)[:, :subsampled_length(T, se.cfg.encoder)]


# ---------------------------------------------------------------------------
# cache-aware streaming: per-layer attention/conv caches, O(chunk) a step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepGeometry:
    """What every layer's attention step shares in one chunk: the position
    table of distances A+C-1 .. -(C-1) (f32, in the compute dtype), the
    gather index of distance A + t - j into it, and the key validity."""
    pe: torch.Tensor     # [A+2C-1, d]
    index: torch.Tensor  # [C, A+C] int64
    valid: torch.Tensor  # [C, A+C] bool

    @classmethod
    def build(cls, cfg: ConformerConfig, A: int, C: int, seen: int, device):
        K = A + C
        t = torch.arange(C, device=device)[:, None]
        j = torch.arange(K, device=device)[None, :]
        # key j is absolute frame seen - A + j: it exists, is not in the
        # query's future (j <= A + t) and is within its left window (j >= t)
        valid = (j >= t) & (j <= A + t) & (j - A + seen >= 0)
        pe = sinusoids(A + C - 1, K + C - 1, cfg.d_model, device).to(cfg.dtype)
        return cls(pe=pe, index=j - t + (C - 1), valid=valid)


def attention_step(attn, h, cache, geom: StepGeometry):
    """One streaming step of ``attn`` (a RelPosSelfAttention): queries
    ``h`` [B, C, d], keys/values [cache | h] (A + C frames). Scores and the
    softmax in f32 from compute-dtype operands. -> (out [B, C, d], the new
    cache: the last A normed inputs)."""
    cfg = attn.cfg
    H, D = cfg.n_heads, cfg.d_model // cfg.n_heads
    B, C, _ = h.shape
    A = cache.shape[1]
    kv = torch.cat([cache.to(h.dtype), h], dim=1)  # [B, K, d]
    q = attn.linear_q(h).view(B, C, H, D)
    k = attn.linear_k(kv).view(B, A + C, H, D)
    v = attn.linear_v(kv).view(B, A + C, H, D)
    p = attn.linear_pos(geom.pe).view(-1, H, D)
    dt = q.dtype
    ac = torch.einsum("bthd,bshd->bhts", (q + cast(attn.pos_bias_u, dt)).float(), k.float())
    bd = torch.einsum("bthd,phd->bhtp", (q + cast(attn.pos_bias_v, dt)).float(), p.float())
    bd = torch.gather(bd, 3, geom.index.expand(B, H, C, A + C))
    scores = ((ac + bd) / math.sqrt(D)).masked_fill(~geom.valid, -1e9)
    probs = torch.where(geom.valid, torch.softmax(scores, dim=-1), 0.0).to(dt)
    out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, C, cfg.d_model)
    return attn.linear_out(out), (kv[:, -A:] if A > 0 else cache)


def conv_module_step(conv, x, cache):
    """One streaming step of ``conv`` (a causal ConformerConvModule): the
    depthwise conv over [cache | chunk] with no padding. -> (out, the new
    cache: the last k-1 GLU outputs)."""
    a, b = conv.pointwise_conv1(x).chunk(2, dim=-1)
    h = a * torch.sigmoid(b)
    hcat = torch.cat([cache.to(h.dtype), h], dim=1)
    out = conv.depthwise_conv(hcat.transpose(1, 2))
    out = F.silu(conv.batch_norm(out)).transpose(1, 2)
    k1 = conv.causal_pad
    return conv.pointwise_conv2(out), (hcat[:, -k1:] if k1 > 0 else cache)


def layer_step(layer, x, att_cache, conv_cache, geom: StepGeometry):
    """One causal ConformerLayer (eval) over a chunk with its caches."""
    x = x + 0.5 * layer.feed_forward1(layer.norm_feed_forward1(x))
    h, new_att = attention_step(layer.self_attn, layer.norm_self_att(x), att_cache, geom)
    x = x + h
    h, new_conv = conv_module_step(layer.conv, layer.norm_conv(x), conv_cache)
    x = x + h
    x = x + 0.5 * layer.feed_forward2(layer.norm_feed_forward2(x))
    return layer.norm_out(x), new_att, new_conv


def subsampling_step(pre, mel_ext, e0: int):
    """The x4 'striding' subsampling of ``pre`` (a ConvSubsampling) over
    mel_ext [B, 4C+3, F], absolute mel frames 4·e0-3 .. 4·(e0+C)-1 (the
    caller puts the 3-frame carry in front) -> enc frames e0 .. e0+C-1,
    equal to the offline subsampling's: time-VALID convs on the halo
    slice, the frequency padded as offline, and conv_0's row at absolute
    index -1 (the offline conv_1's zero padding) zeroed."""
    conv0, conv1 = pre.convs
    dt = conv0.dtype
    h = F.relu(F.conv2d(mel_ext[:, None].to(dt), cast(conv0.weight, dt),
                        cast(conv0.bias, dt), stride=2, padding=(0, 1)))
    if e0 == 0:  # row m is conv_0's output at absolute index 2·e0 - 1 + m
        h[:, :, 0] = 0.0
    h = F.relu(F.conv2d(h, cast(conv1.weight, dt), cast(conv1.bias, dt), stride=2,
                        padding=(0, 1)))
    B, Ch, C, F4 = h.shape
    return pre.out(h.permute(0, 2, 3, 1).reshape(B, C, F4 * Ch))


def encoder_step(encoder, mel_ext, e0: int, att_cache, conv_cache, geom: StepGeometry):
    """One cache-aware step of ``encoder`` (a ConformerEncoder): mel slice
    [B, n_mels, 4C+3] -> (enc chunk [B, C, d], new caches [L, B, ., d])."""
    cfg = encoder.cfg
    x = subsampling_step(encoder.pre_encode, mel_ext.transpose(1, 2), e0)
    if cfg.xscale:
        x = x * math.sqrt(cfg.d_model)
    new_att, new_conv = [], []
    for i, layer in enumerate(encoder.layers):
        x, na, nc = layer_step(layer, x, att_cache[i], conv_cache[i], geom)
        new_att.append(na)
        new_conv.append(nc)
    return x, torch.stack(new_att), torch.stack(new_conv)


@dataclasses.dataclass
class CacheState:
    mel_carry: torch.Tensor   # [B, n_mels, 3] last 3 mel frames
    att_cache: torch.Tensor   # [L, B, A, d]
    conv_cache: torch.Tensor  # [L, B, k-1, d]
    e0: int = 0               # enc frames emitted so far


class CacheAwareStreamer:
    """Streams a causal Conformer encoder chunk by chunk at O(chunk) cost.

    Needs ``causal_conv=True``, ``att_context_size=(A >= 0, 0)``, x4
    subsampling, a batch_norm or layer_norm conv norm and no global tokens.
    Equals the offline encoder for mel lengths that are multiples of 4 (the
    subsampling emits whole frames). ``encoder`` is a ConformerEncoder or a
    model that holds one."""

    def __init__(self, encoder, chunk_mel: int = 64):
        encoder = getattr(encoder, "encoder", encoder)
        cfg = encoder.cfg
        if not cfg.causal_conv:
            raise ValueError("cache-aware streaming needs causal_conv")
        if not (cfg.att_context_size[0] >= 0 and cfg.att_context_size[1] == 0):
            raise ValueError("cache-aware streaming needs att_context_size=(A>=0, 0)")
        if chunk_mel % 4 or chunk_mel <= 0:
            raise ValueError(f"chunk_mel={chunk_mel}: a positive multiple of 4")
        if cfg.sampling_num != 2:
            raise ValueError("streaming subsampling assumes x4")
        if cfg.conv_norm_type not in ("batch_norm", "layer_norm"):
            raise ValueError("cache-aware streaming supports batch_norm/layer_norm, "
                             f"got {cfg.conv_norm_type}")
        if cfg.global_tokens > 0:
            raise ValueError("global tokens attend to the future: no streaming step")
        self.encoder = encoder.eval()
        self.cfg = cfg
        self.chunk_mel = chunk_mel

    @property
    def device(self) -> torch.device:
        return self.encoder.pre_encode.out.weight.device

    def init(self, batch_size: int) -> CacheState:
        cfg, dev = self.cfg, self.device
        A, L, d = cfg.att_context_size[0], cfg.n_layers, cfg.d_model
        return CacheState(
            mel_carry=torch.zeros((batch_size, cfg.feat_in, 3), device=dev),
            att_cache=torch.zeros((L, batch_size, A, d), dtype=cfg.dtype, device=dev),
            conv_cache=torch.zeros((L, batch_size, cfg.conv_kernel_size - 1, d),
                                   dtype=cfg.dtype, device=dev),
        )

    def step(self, state: CacheState, chunk: torch.Tensor):
        """chunk [B, n_mels, chunk_mel] -> (enc chunk [B, chunk_mel/4, d],
        new state)."""
        if chunk.shape[-1] != self.chunk_mel:
            raise ValueError(f"a chunk holds {self.chunk_mel} mel frames, "
                             f"got {chunk.shape[-1]}")
        chunk = chunk.to(self.device, torch.float32)
        C = self.chunk_mel // 4
        with torch.inference_mode():
            geom = StepGeometry.build(self.cfg, state.att_cache.shape[2], C, state.e0,
                                      self.device)
            x, att, conv = encoder_step(
                self.encoder, torch.cat([state.mel_carry, chunk], dim=-1), state.e0,
                state.att_cache, state.conv_cache, geom)
        return x, CacheState(mel_carry=chunk[:, :, -3:], att_cache=att, conv_cache=conv,
                             e0=state.e0 + C)


def stream_full_utterance_cached(streamer: CacheAwareStreamer, mel: torch.Tensor):
    """A whole [B, n_mels, T] mel (T % 4 == 0) through the cache-aware
    streamer -> the enc frames [B, T/4, d], concatenated."""
    B, _, T = mel.shape
    C = streamer.chunk_mel
    mel = F.pad(mel, (0, -T % C))
    state = streamer.init(B)
    outs = []
    for c0 in range(0, mel.shape[-1], C):
        x, state = streamer.step(state, mel[:, :, c0:c0 + C])
        outs.append(x)
    return torch.cat(outs, dim=1)[:, :T // 4]


class StreamingASR:
    """Streaming recognizer: mel chunks in, an incremental token stream
    out, at O(chunk) cost a step: ``CacheAwareStreamer`` plus the greedy
    decode's continuation over the model's ``joint_project_enc``,
    ``pred_step`` and ``joint_step``. On a causal config the chunked tokens
    equal the offline greedy decode's.

    The mel stream is the input contract: the offline front-end normalises
    each feature over the utterance, so a live deployment needs a causal
    normalisation; feed this class the mel the serving stack produces."""

    def __init__(self, model, *, chunk_mel: int = 64, max_symbols: int = 10,
                 max_out: int = 256):
        self.model = model.eval()
        self.streamer = CacheAwareStreamer(model.encoder, chunk_mel)
        self.blank = model.cfg.blank_local
        self.max_symbols = max_symbols
        self.max_out = max_out

    def init(self, batch_size: int) -> dict:
        return {"enc": self.streamer.init(batch_size), "dec": None, "frames": 0}

    def step(self, state: dict, mel_chunk: torch.Tensor, lang_ids: torch.Tensor,
             valid_mel: torch.Tensor | None = None):
        """mel_chunk [B, n_mels, chunk_mel] -> ((tokens [B, max_out], lens
        [B]) so far, new state).

        ``valid_mel`` [B] (optional): how many of this chunk's mel frames
        are real audio. A final partial chunk must be zero-padded to
        ``chunk_mel`` frames; without ``valid_mel`` the padding would be
        decoded as audio. Each row's frame budget takes the encoder's
        ceil(v / factor) length rule."""
        model, dev = self.model, self.streamer.device
        enc_chunk, enc_state = self.streamer.step(state["enc"], mel_chunk)
        B, C = enc_chunk.shape[:2]
        if valid_mel is None:
            valid = torch.full((B,), C, dtype=torch.int32, device=dev)
        else:
            factor = self.streamer.cfg.subsampling_factor
            valid = torch.clamp(-(-valid_mel.to(dev, torch.int32) // factor), max=C)
        total = state["frames"] + valid
        with torch.inference_mode():
            out, out_len, carry = rnnt_greedy_decode(
                model.joint_project_enc(enc_chunk), total, lang_ids.to(dev),
                model.pred_step, model.joint_step, None, blank=self.blank,
                max_symbols=self.max_symbols, max_out=self.max_out, carry=state["dec"],
                t_offset=state["frames"], return_carry=True)
        return (out, out_len), {"enc": enc_state, "dec": carry,
                                "frames": state["frames"] + C}
