"""Seq2seq machine-translation model (attention encoder-decoder).

Reference parity: ``benchmark/fluid/models/machine_translation.py``
(seq_to_seq_net: bi-LSTM encoder + simple_attention LSTM decoder) and the
generation path of ``tests/book/test_machine_translation.py`` (beam search).
Dense-padded regime: [batch, max_len] token ids + [batch] lengths replace
LoD packing; the decoder is the fused attention_lstm op, and generation
is the fused whole-loop beam decoder.

Counterpart of ``paddle_tpu/models/machine_translation.py``: the
training graph (``build``) and the generation graph (``build_generator``,
the whole-loop beam decoder ``attention_lstm_beam_decode``), which share
the weights by name.
"""

import paddle_tpu_torch as fluid
from paddle_tpu_torch.param_attr import ParamAttr

DECODER_NAME = "mt_decoder"
TGT_EMB_NAME = "mt_tgt_emb_table"


def _encoder(src_word_idx, src_len, src_vocab, emb_dim, encoder_size,
             decoder_size):
    src_emb = fluid.layers.embedding(
        input=src_word_idx, size=[src_vocab, emb_dim],
        param_attr=ParamAttr(name="mt_src_emb_table"),
    )
    fwd_proj = fluid.layers.fc(
        input=src_emb, size=encoder_size * 4, num_flatten_dims=2,
        bias_attr=False, param_attr=ParamAttr(name="mt_enc_fwd_proj_w"),
    )
    fwd, _ = fluid.layers.dynamic_lstm(
        input=fwd_proj, size=encoder_size * 4, length=src_len,
        use_peepholes=False, param_attr=ParamAttr(name="mt_enc_fwd_w"),
        bias_attr=ParamAttr(name="mt_enc_fwd_b"),
    )
    rev_proj = fluid.layers.fc(
        input=src_emb, size=encoder_size * 4, num_flatten_dims=2,
        bias_attr=False, param_attr=ParamAttr(name="mt_enc_rev_proj_w"),
    )
    rev, _ = fluid.layers.dynamic_lstm(
        input=rev_proj, size=encoder_size * 4, length=src_len,
        is_reverse=True, use_peepholes=False,
        param_attr=ParamAttr(name="mt_enc_rev_w"),
        bias_attr=ParamAttr(name="mt_enc_rev_b"),
    )
    encoded_vector = fluid.layers.concat([fwd, rev], axis=2)  # [B, S, 2H]
    encoded_proj = fluid.layers.fc(
        input=encoded_vector, size=decoder_size, num_flatten_dims=2,
        bias_attr=False, param_attr=ParamAttr(name="mt_enc_proj_w"),
    )
    # State after the reversed pass over the full sequence seeds the decoder.
    backward_first = fluid.layers.sequence_pool(
        input=rev, pool_type="first"
    )
    decoder_boot = fluid.layers.fc(
        input=backward_first, size=decoder_size, act="tanh", bias_attr=False,
        param_attr=ParamAttr(name="mt_dec_boot_w"),
    )
    return encoded_vector, encoded_proj, decoder_boot


def build(
    src_vocab=1000,
    tgt_vocab=1000,
    src_seq_len=32,
    tgt_seq_len=32,
    emb_dim=64,
    encoder_size=64,
    decoder_size=64,
):
    """Training graph. Feeds: source_sequence [B, Ts] int64, source_length
    [B] int64, target_sequence [B, Tt] int64 (shifted-right, <s> first),
    label [B, Tt] int64, label_mask [B, Tt] float32 (1 on real tokens)."""
    src = fluid.layers.data(
        name="source_sequence", shape=[src_seq_len], dtype="int64"
    )
    src_len = fluid.layers.data(name="source_length", shape=[1],
                                dtype="int64")
    tgt = fluid.layers.data(
        name="target_sequence", shape=[tgt_seq_len], dtype="int64"
    )
    label = fluid.layers.data(name="label", shape=[tgt_seq_len],
                              dtype="int64")
    label_mask = fluid.layers.data(
        name="label_mask", shape=[tgt_seq_len], dtype="float32"
    )

    encoded_vector, encoded_proj, decoder_boot = _encoder(
        src, src_len, src_vocab, emb_dim, encoder_size, decoder_size
    )

    tgt_emb = fluid.layers.embedding(
        input=tgt, size=[tgt_vocab, emb_dim],
        param_attr=ParamAttr(name=TGT_EMB_NAME),
    )
    dec_hidden = fluid.layers.attention_lstm_decoder(
        tgt_emb, encoded_vector, encoded_proj, decoder_boot,
        size=decoder_size, encoder_len=src_len, name=DECODER_NAME,
    )
    logits = fluid.layers.fc(
        input=dec_hidden, size=tgt_vocab, num_flatten_dims=2,
        param_attr=ParamAttr(name=DECODER_NAME + "_out_w"),
        bias_attr=ParamAttr(name=DECODER_NAME + "_out_b"),
    )
    # Per-token CE, masked mean over real tokens.
    flat_logits = fluid.layers.reshape(logits, shape=[-1, tgt_vocab])
    flat_label = fluid.layers.reshape(label, shape=[-1, 1])
    tok_loss = fluid.layers.softmax_with_cross_entropy(
        flat_logits, flat_label
    )
    tok_loss = fluid.layers.reshape(tok_loss, shape=[-1, tgt_seq_len])
    masked = fluid.layers.elementwise_mul(tok_loss, label_mask)
    total = fluid.layers.reduce_sum(masked)
    denom = fluid.layers.reduce_sum(label_mask)
    avg_cost = fluid.layers.elementwise_div(total, denom)
    return avg_cost, [src, src_len, tgt, label, label_mask], {}


def build_generator(src_vocab=1000, tgt_vocab=1000, src_seq_len=32,
                    emb_dim=64, encoder_size=64, decoder_size=64,
                    beam_size=4, max_len=32, start_id=1, end_id=2):
    """The beam-search generation graph, sharing the training weights by
    name. Returns (sentence_ids ``[B, beam, max_len]``, scores ``[B,
    beam]``, feeds)."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    src = fluid.layers.data(name="source_sequence", shape=[src_seq_len],
                            dtype="int64")
    src_len = fluid.layers.data(name="source_length", shape=[1],
                                dtype="int64")
    encoded_vector, encoded_proj, decoder_boot = _encoder(
        src, src_len, src_vocab, emb_dim, encoder_size, decoder_size)
    helper = LayerHelper("mt_generator")
    tgt_emb_param = helper.create_parameter(
        attr=ParamAttr(name=TGT_EMB_NAME), shape=[tgt_vocab, emb_dim],
        dtype="float32")
    ids, scores = fluid.layers.attention_lstm_beam_decode(
        encoded_vector, encoded_proj, decoder_boot, tgt_emb_param,
        size=decoder_size, vocab_size=tgt_vocab, beam_size=beam_size,
        max_len=max_len, start_id=start_id, end_id=end_id,
        encoder_len=src_len, name=DECODER_NAME)
    return ids, scores, [src, src_len]
