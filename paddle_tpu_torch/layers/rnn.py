"""Recurrent layers: dynamic_lstm, dynamic_lstmp, dynamic_gru, gru_unit,
lstm_unit, row_conv, the attention-LSTM decoder and its beam generator,
and the dense beam-search step and backtrack.

Counterpart of ``paddle_tpu/layers/rnn.py``, with the same parameter
names, shapes and ``LayerHelper`` types,
so that both packages name (and seed) their parameters alike. As in the
reference, ``dynamic_lstm(input, size=4*D)`` expects the caller to have
projected the raw features with an ``fc`` of size 4*D; ``input`` is a
dense-padded ``[batch, max_len, size]`` with an optional ``length``.
"""

from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = [
    "dynamic_lstm",
    "dynamic_lstmp",
    "dynamic_gru",
    "gru_unit",
    "lstm_unit",
    "row_conv",
    "attention_lstm_decoder",
    "attention_lstm_beam_decode",
    "beam_search",
    "beam_search_decode",
]


def dynamic_lstm(input, size, length=None, h_0=None, c_0=None,
                 param_attr=None, bias_attr=None, use_peepholes=True,
                 is_reverse=False, gate_activation="sigmoid",
                 cell_activation="tanh", candidate_activation="tanh",
                 dtype="float32", name=None):
    """LSTM over a padded sequence; ``size`` = 4 * hidden_dim. Returns
    (hidden, cell), each ``[B, T, hidden_dim]``."""
    helper = LayerHelper("lstm", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    assert size % 4 == 0, "size must be 4 * hidden_dim"
    hidden = size // 4
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[hidden, 4 * hidden], dtype=dtype)
    bias_size = [1, 7 * hidden] if use_peepholes else [1, 4 * hidden]
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=bias_size, dtype=dtype, is_bias=True)
    hidden_out = helper.create_variable_for_type_inference(dtype)
    cell_out = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="dynamic_lstm",
        inputs=inputs,
        outputs={"Hidden": [hidden_out], "Cell": [cell_out]},
        attrs={
            "use_peepholes": use_peepholes,
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
        },
    )
    return hidden_out, cell_out


def dynamic_lstmp(input, size, proj_size, length=None, param_attr=None,
                  bias_attr=None, use_peepholes=True,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    """Projected LSTM (lstmp_op.cc); ``size`` = 4 * hidden, ``proj_size``
    = P. Returns (projection ``[B, T, P]``, cell ``[B, T, hidden]``)."""
    helper = LayerHelper("lstmp", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    assert size % 4 == 0
    hidden = size // 4
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[proj_size, 4 * hidden], dtype=dtype)
    proj_weight = helper.create_parameter(
        attr=helper.param_attr, shape=[hidden, proj_size], dtype=dtype)
    bias_size = [1, 7 * hidden] if use_peepholes else [1, 4 * hidden]
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=bias_size, dtype=dtype, is_bias=True)
    proj_out = helper.create_variable_for_type_inference(dtype)
    cell_out = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight],
              "ProjWeight": [proj_weight], "Bias": [bias]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="dynamic_lstmp",
        inputs=inputs,
        outputs={"Projection": [proj_out], "Cell": [cell_out]},
        attrs={
            "use_peepholes": use_peepholes,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
            "proj_activation": proj_activation,
        },
    )
    return proj_out, cell_out


def dynamic_gru(input, size, length=None, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, name=None):
    """GRU over a padded sequence; ``input`` is ``[B, T, 3 * size]``."""
    helper = LayerHelper("gru", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dtype = input.dtype
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=[1, 3 * size], dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="dynamic_gru",
        inputs=inputs,
        outputs={"Hidden": [hidden]},
        attrs={
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "activation": candidate_activation,
        },
    )
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """One GRU step (gru_unit_op.cc), for StaticRNN bodies; ``size`` = 3 *
    hidden. Returns (hidden, reset_hidden_prev, gate)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    dtype = input.dtype
    size = size // 3
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=[1, 3 * size], dtype=dtype, is_bias=True)
    gate = helper.create_variable_for_type_inference(dtype)
    reset_hidden_pre = helper.create_variable_for_type_inference(dtype)
    updated_hidden = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="gru_unit",
        inputs={"Input": [input], "HiddenPrev": [hidden],
                "Weight": [weight], "Bias": [bias]},
        outputs={"Gate": [gate], "ResetHiddenPrev": [reset_hidden_pre],
                 "Hidden": [updated_hidden]},
        attrs={"activation": activation,
               "gate_activation": gate_activation},
    )
    return updated_hidden, reset_hidden_pre, gate


def lstm_unit(x_t, c_prev, forget_bias=0.0, name=None):
    """One LSTM step over pre-projected gates ``x_t`` ``[B, 4D]``
    (lstm_unit_op.cc). Returns (h, c)."""
    helper = LayerHelper("lstm_unit", name=name)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op(
        type="lstm_unit",
        inputs={"X": [x_t], "C_prev": [c_prev]},
        outputs={"C": [c], "H": [h]},
        attrs={"forget_bias": float(forget_bias)},
    )
    return h, c


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead row convolution (row_conv_op.cc) over ``[B, T, D]``."""
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    dtype = input.dtype
    filter_shape = [future_context_size + 1, int(input.shape[-1])]
    filter_param = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="row_conv",
        inputs={"X": [input], "Filter": [filter_param]},
        outputs={"Out": [out]},
    )
    return helper.append_activation(out)


def _decoder_params(helper, name, decoder_size, ctx_dim, emb_dim, vocab=None,
                    dtype="float32"):
    """Create (or reuse by name) the attention decoder's parameters, with
    fixed names keyed on ``name`` (rnn.py:252), so that a training program
    and a separately built generation program share them through the
    scope; ``vocab`` adds the output projection."""
    d = decoder_size

    def p(suffix, shape, is_bias=False):
        return helper.create_parameter(
            attr=ParamAttr(name="%s_%s" % (name, suffix)), shape=shape,
            dtype=dtype, is_bias=is_bias)

    params = {
        "StateProjW": p("state_proj_w", [d, d]),
        "AttnW": p("attn_w", [2 * d, 1]),
        "CellW": p("cell_w", [d + ctx_dim + emb_dim, 4 * d]),
        "CellB": p("cell_b", [1, 4 * d], is_bias=True),
    }
    if vocab is not None:
        params["OutW"] = p("out_w", [d, vocab])
        # 1-D, so that the training program's fc(num_flatten_dims=2)
        # output bias of the same name is shared
        params["OutB"] = p("out_b", [vocab], is_bias=True)
    return params


def attention_lstm_decoder(target_embedding, encoder_vec, encoder_proj,
                           decoder_boot, size, encoder_len=None,
                           name="attention_decoder"):
    """Teacher-forced attention-LSTM decoder (attention_lstm_op.cc
    parity). target_embedding ``[B, T, M]``; encoder_vec ``[B, S, C]``;
    encoder_proj ``[B, S, size]``; decoder_boot ``[B, size]``. Returns
    the hidden states ``[B, T, size]``."""
    helper = LayerHelper("attention_lstm", name=name)
    dtype = target_embedding.dtype
    params = _decoder_params(helper, name, size, int(encoder_vec.shape[-1]),
                             int(target_embedding.shape[-1]), dtype=dtype)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    attn = helper.create_variable_for_type_inference(dtype)
    inputs = {
        "X": [target_embedding],
        "EncoderVec": [encoder_vec],
        "EncoderProj": [encoder_proj],
        "H0": [decoder_boot],
    }
    inputs.update({k: [v] for k, v in params.items()})
    if encoder_len is not None:
        inputs["EncoderLen"] = [encoder_len]
    helper.append_op(
        type="attention_lstm",
        inputs=inputs,
        outputs={"Hidden": [hidden], "Cell": [cell],
                 "AttentionWeight": [attn]},
    )
    return hidden


def attention_lstm_beam_decode(encoder_vec, encoder_proj, decoder_boot,
                               embedding_param, size, vocab_size,
                               beam_size=4, max_len=32, start_id=1,
                               end_id=2, encoder_len=None,
                               name="attention_decoder"):
    """Whole-loop beam-search generation with the decoder named ``name``
    (its weights are ``attention_lstm_decoder``'s). Returns
    (sentence_ids ``[B, beam, max_len]``, sentence_scores ``[B,
    beam]``)."""
    helper = LayerHelper("attention_lstm_beam_decode", name=name)
    dtype = encoder_vec.dtype
    params = _decoder_params(helper, name, size, int(encoder_vec.shape[-1]),
                             int(embedding_param.shape[-1]),
                             vocab=vocab_size, dtype=dtype)
    ids = helper.create_variable_for_type_inference("int32")
    scores = helper.create_variable_for_type_inference(dtype)
    inputs = {
        "EncoderVec": [encoder_vec],
        "EncoderProj": [encoder_proj],
        "H0": [decoder_boot],
        "Embedding": [embedding_param],
    }
    inputs.update({k: [v] for k, v in params.items()})
    if encoder_len is not None:
        inputs["EncoderLen"] = [encoder_len]
    helper.append_op(
        type="attention_lstm_beam_decode",
        inputs=inputs,
        outputs={"SentenceIds": [ids], "SentenceScores": [scores]},
        attrs={"beam_size": int(beam_size), "max_len": int(max_len),
               "start_id": int(start_id), "end_id": int(end_id)},
    )
    return ids, scores


def beam_search(pre_ids, pre_scores, scores, beam_size, end_id=0,
                is_accumulated=True, name=None):
    """One dense beam-search step (beam_search_op.cc parity).
    ``pre_ids`` / ``pre_scores`` ``[B, K]``; ``scores`` ``[B, K, V]``
    (accumulated log-probs, or per-step probabilities when
    ``is_accumulated=False``). Returns (selected_ids, selected_scores,
    parent_idx), each ``[B, K]``."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference(pre_ids.dtype)
    sel_scores = helper.create_variable_for_type_inference(pre_scores.dtype)
    parent = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="beam_search",
        inputs={"pre_ids": [pre_ids], "pre_scores": [pre_scores],
                "scores": [scores]},
        outputs={"selected_ids": [sel_ids], "selected_scores": [sel_scores],
                 "parent_idx": [parent]},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id),
               "is_accumulated": bool(is_accumulated)},
    )
    return sel_ids, sel_scores, parent


def beam_search_decode(ids, parent_idx, scores=None, beam_size=4, end_id=0,
                       name=None):
    """Backtrack the stacked per-step beams (``[T, B, K]`` ids and
    parents) into sentences ``[B, K, T]`` (beam_search_decode_op.cc
    parity). With the per-step selected ``scores`` ``[T, B, K]`` they are
    gathered along the same lattice into per-token scores ``[B, K, T]``
    (zeros otherwise)."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent_ids = helper.create_variable_for_type_inference(ids.dtype)
    sent_scores = helper.create_variable_for_type_inference("float32")
    inputs = {"Ids": [ids], "ParentIdx": [parent_idx]}
    if scores is not None:
        inputs["Scores"] = [scores]
    helper.append_op(
        type="beam_search_decode",
        inputs=inputs,
        outputs={"SentenceIds": [sent_ids], "SentenceScores": [sent_scores]},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id)},
    )
    return sent_ids, sent_scores
