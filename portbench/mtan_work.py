"""Work counts of mTAN's p1 step (`portbench/reference/mtan.py`): the model's
floating-point operations a train step, for `mfu.p1`, and the least time of
the encoder attention's kernel pair M1 (the program's `csrc/mtan.cu`), for
`mtan_attn_roofline.p1`.

The pair's bound counts its inputs read once and its outputs written once
at the HBM rate, or its float32 operations and `expf` at their peak rates,
whichever is longer (`work.bound`, the H100 SXM data sheet's rates). The
pair computes no `sinf`: the keys' time embedding is the program's plain
PyTorch, before the kernel. Its work follows the observed slots, as the
kernels do: a score a (query, observed key) pair.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.work import F32, bound

# models.py's fixed widths: the z-heads' and the decoder output MLP's hidden
# layer, the classifier's MLP
Z_HIDDEN = 50
CLASSIFIER_HIDDEN = 300


@dataclass
class Shapes:
    """A step's shapes: the batch, channels and slots, the reference points,
    the time embedding, the encoder's (and classifier's) and the decoder's
    GRU widths, the latent, and the mean observed slots of an encounter."""
    b: int
    c: int
    t: int
    r: int
    e: int
    h: int
    g: int
    latent: int
    obs_per_encounter: float


def shapes(cfg, raw) -> Shapes:
    """The shapes of the program's `cfg` over the training cohort `raw`."""
    mask = raw["training"]["padding_mask"]
    return Shapes(b=cfg.batch_size, c=cfg.num_variables, t=cfg.num_timestamps,
                  r=cfg.mtan_ref_points, e=cfg.mtan_embed_time, h=cfg.mtan_rec_hidden,
                  g=cfg.mtan_gen_hidden, latent=cfg.mtan_latent_dim,
                  obs_per_encounter=float(mask.sum(dtype=np.float64)) / mask.shape[0])


def attention_forward_work(s: Shapes):
    """(bytes, flop, expf) of M1's forward over a batch: the queries, the
    observed keys' rows of K, every slot's ob and mask in; four (heads, R)
    outputs out. A (query, observed key) pair: 2E for its score, ~6 for the
    online softmax and the two weighted sums, one expf."""
    heads, pairs = s.b * s.c, s.r * s.b * s.obs_per_encounter
    n_bytes = F32 * (s.r * s.e + s.b * s.obs_per_encounter * s.e + 2 * heads * s.t
                     + 4 * heads * s.r)
    return n_bytes, pairs * (2 * s.e + 6), pairs


def attention_backward_work(s: Shapes):
    """(bytes, flop, expf) of M1's backward over a batch: the forward's
    inputs, its three outputs and the two cotangents in; dK (every slot),
    dob and dQ out. A (query, observed key) pair: 2E for the score again,
    2E each for dK and dQ, ~8 for alpha, ds and dob, one expf."""
    heads, pairs = s.b * s.c, s.r * s.b * s.obs_per_encounter
    n_bytes = F32 * (s.r * s.e + s.b * s.obs_per_encounter * s.e + 2 * heads * s.t
                     + 5 * heads * s.r + heads * s.t * s.e + heads * s.t + s.r * s.e)
    return n_bytes, pairs * (6 * s.e + 8), pairs


def bound_ms(work) -> float:
    return bound(*work)[0]


def attention_step_ms(s: Shapes) -> float:
    """The pair's least time in a train step: the forward's and the
    backward's bounds."""
    return bound_ms(attention_forward_work(s)) + bound_ms(attention_backward_work(s))


def model_flops(s: Shapes, train: bool = True) -> float:
    """The model's floating-point operations for one batch, from the shapes:
    every product of the encoder (the keys' projection at each observed
    slot, the queries', the scores and weighted sums over the observed
    keys, W_o, the biGRU, the z-heads), of the decoder (its biGRU; at each
    of the batch's observed target slots the query's projection, the
    scores over the R keys, the weighted sum, W_o and the output MLP) and
    of the classifier (its GRU and MLP), 2 a multiply-add; a GRU's ~12 gate
    operations a unit and step, the softmaxes' ~5 an entry. Work on padded
    slots is not the model's and is not counted (the program does it at
    every one of the C * T slots). A train step counts the backward as
    twice the forward; no recompute is counted, and the losses and the
    optimizer are left out (under 0.1%)."""
    b, c, r, e, h, g, lat = s.b, s.c, s.r, s.e, s.h, s.g, s.latent
    observed = b * s.obs_per_encounter

    def gru(rows, inp, hid, dirs):  # (products, gate operations) over the R steps
        return dirs * r * rows * 2 * 3 * hid * (inp + hid), dirs * r * rows * 12 * hid

    enc_gru, enc_gates = gru(b, h, h, 2)
    dec_gru, dec_gates = gru(b, lat, g, 2)
    cls_gru, cls_gates = gru(b, lat, h, 1)
    encoder = (2 * observed * e * e + 2 * r * e * e  # W_k at each observed slot, W_q
               + observed * r * (2 * e + 2 * 2)  # scores, the two weighted sums
               + 2 * b * r * 2 * c * h  # W_o
               + enc_gru + 2 * b * r * (2 * h * Z_HIDDEN + Z_HIDDEN * 2 * lat))
    decoder = (dec_gru + 2 * r * e * e
               + observed * 2 * (e * e + r * e + r * 2 * g + 2 * g * 2 * g
                              + 2 * g * Z_HIDDEN + Z_HIDDEN * c))
    classifier = cls_gru + 2 * b * (h * CLASSIFIER_HIDDEN + CLASSIFIER_HIDDEN ** 2
                                    + CLASSIFIER_HIDDEN * c)
    pointwise = enc_gates + dec_gates + cls_gates + 2 * 5 * observed * r
    forward = encoder + decoder + classifier + pointwise
    return 3 * forward if train else forward
