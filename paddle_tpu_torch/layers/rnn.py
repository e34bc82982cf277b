"""Recurrent layers: dynamic_lstm, dynamic_gru, attention_lstm_decoder.

Counterpart of ``paddle_tpu/layers/rnn.py`` for the layers the RNN slice
calls, with the same parameter names, shapes and ``LayerHelper`` types,
so that both packages name (and seed) their parameters alike. As in the
reference, ``dynamic_lstm(input, size=4*D)`` expects the caller to have
projected the raw features with an ``fc`` of size 4*D; ``input`` is a
dense-padded ``[batch, max_len, size]`` with an optional ``length``.
"""

from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["dynamic_lstm", "dynamic_gru", "attention_lstm_decoder"]


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


def _decoder_params(helper, name, decoder_size, ctx_dim, emb_dim,
                    dtype="float32"):
    """Create (or reuse by name) the attention decoder's parameters, with
    fixed names keyed on ``name`` (rnn.py:252)."""
    d = decoder_size

    def p(suffix, shape, is_bias=False):
        return helper.create_parameter(
            attr=ParamAttr(name="%s_%s" % (name, suffix)), shape=shape,
            dtype=dtype, is_bias=is_bias)

    return {
        "StateProjW": p("state_proj_w", [d, d]),
        "AttnW": p("attn_w", [2 * d, 1]),
        "CellW": p("cell_w", [d + ctx_dim + emb_dim, 4 * d]),
        "CellB": p("cell_b", [1, 4 * d], is_bias=True),
    }


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
