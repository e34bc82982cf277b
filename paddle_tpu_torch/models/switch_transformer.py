"""Switch-Transformer encoder classifier: sparse MoE FFN layers.

Counterpart of ``paddle_tpu/models/switch_transformer.py``, the same
program with the same variable names: built from the blocks of
models/transformer.py with every ``moe_every``-th encoder layer's dense
FFN replaced by ``fluid.layers.moe_ffn`` (Switch routing,
ops/moe_ops.py). The self-attention has a [B, T] key mask, so it runs
the flash kernels (B1 forward, B2 and B3 backward). The load-balancing
auxiliary losses are summed and folded into the returned training loss
with weight ``aux_weight``. Expert parallelism is A10's.
"""

import paddle_tpu_torch as fluid

from paddle_tpu_torch.models.transformer import (
    _prenorm,
    _residual,
    _self_attention_block,
    encoder_layer,
)


def _moe_encoder_layer(x, mask, n_head, d_model, d_inner, num_experts,
                       top_k, dropout, is_test, name):
    x = _self_attention_block(x, mask, n_head, d_model, dropout, is_test,
                              name)
    ff, aux = fluid.layers.moe_ffn(
        _prenorm(x, name + "_ffn"), num_experts=num_experts,
        d_hidden=d_inner, top_k=top_k, mask=mask,
        param_attr=fluid.ParamAttr(name=name + "_moe"),
        name=name + "_moe",
    )
    return _residual(x, ff, dropout, is_test, name + "_res2"), aux


def build(
    vocab_size=1000,
    max_length=64,
    n_layer=4,
    n_head=4,
    d_model=128,
    d_inner=256,
    num_experts=4,
    top_k=1,
    moe_every=2,
    aux_weight=1e-2,
    num_classes=2,
    dropout=0.0,
    is_test=False,
):
    """Sequence classifier over a Switch encoder stack. Returns
    (loss, feeds, extras): extras carries ``logits`` and the summed
    ``aux_loss``. Feeds: word [B, T], seq_len [B, 1], label [B, 1]."""
    word = fluid.layers.data("word", shape=[max_length], dtype="int64")
    seq_len = fluid.layers.data("seq_len", shape=[1], dtype="int64")
    label = fluid.layers.data("label", shape=[1], dtype="int64")

    mask = fluid.layers.sequence_mask(
        seq_len, maxlen=max_length, dtype="float32")
    emb = fluid.layers.embedding(
        input=word, size=[vocab_size, d_model],
        param_attr=fluid.ParamAttr(name="switch_emb"))
    emb = fluid.layers.scale(emb, scale=d_model ** 0.5)
    h = fluid.layers.add_position_encoding(emb)

    aux_losses = []
    for i in range(n_layer):
        name = "switch_%d" % i
        if moe_every and (i + 1) % moe_every == 0:
            h, aux = _moe_encoder_layer(
                h, mask, n_head, d_model, d_inner, num_experts, top_k,
                dropout, is_test, name)
            aux_losses.append(aux)
        else:
            h = encoder_layer(
                h, mask, n_head, d_model, d_inner, dropout, is_test, name)
    h = _prenorm(h, "switch_final")

    # masked mean-pool over valid positions, then classify
    m = fluid.layers.unsqueeze(mask, axes=[2])
    pooled = fluid.layers.elementwise_div(
        fluid.layers.reduce_sum(
            fluid.layers.elementwise_mul(h, m), dim=1),
        fluid.layers.reduce_sum(m, dim=1),
    )
    logits = fluid.layers.fc(pooled, size=num_classes, name="switch_head")
    ce = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))

    aux_total = None
    for a in aux_losses:
        am = fluid.layers.mean(a)
        aux_total = am if aux_total is None else aux_total + am
    loss = ce if aux_total is None else ce + aux_weight * aux_total

    feeds = [word, seq_len, label]
    return loss, feeds, {"logits": logits, "aux_loss": aux_total,
                         "ce_loss": ce}
