"""Structured-prediction and large-vocabulary NLP layers.

Counterpart of ``paddle_tpu/layers/nlp.py`` (layers/nn.py
linear_chain_crf, crf_decoding, warpctc, ctc_greedy_decoder,
edit_distance, chunk_eval, nce, hsigmoid parity), with the same names,
signatures and parameter shapes, on the ops of ``ops/crf_ops.py``,
``ops/ctc_ops.py``, ``ops/sampling_ops.py`` and ``ops/metric_ops.py``.
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = [
    "linear_chain_crf",
    "crf_decoding",
    "warpctc",
    "ctc_greedy_decoder",
    "edit_distance",
    "chunk_eval",
    "nce",
    "hsigmoid",
]


def linear_chain_crf(input, label, length=None, param_attr=None, name=None):
    """CRF NLL cost [B, 1]; creates the [num_tags+2, num_tags] transition
    parameter (rows 0/1 = start/stop weights)."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr,
                         name=name)
    num_tags = int(input.shape[-1])
    transition = helper.create_parameter(
        attr=helper.param_attr, shape=[num_tags + 2, num_tags],
        dtype=input.dtype,
    )
    alpha = helper.create_variable_for_type_inference(input.dtype)
    emission_exps = helper.create_variable_for_type_inference(input.dtype)
    transition_exps = helper.create_variable_for_type_inference(input.dtype)
    log_likelihood = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Emission": [input], "Transition": [transition],
              "Label": [label]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="linear_chain_crf",
        inputs=inputs,
        outputs={
            "Alpha": [alpha],
            "EmissionExps": [emission_exps],
            "TransitionExps": [transition_exps],
            "LogLikelihood": [log_likelihood],
        },
    )
    return log_likelihood


def crf_decoding(input, param_attr, label=None, length=None, name=None):
    """Viterbi path [B, T] (or 0/1 correctness when label is given); reuses
    the transition parameter created by linear_chain_crf via param_attr."""
    helper = LayerHelper("crf_decoding", param_attr=param_attr, name=name)
    num_tags = int(input.shape[-1])
    transition = helper.create_parameter(
        attr=helper.param_attr, shape=[num_tags + 2, num_tags],
        dtype=input.dtype,
    )
    path = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True
    )
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="crf_decoding",
        inputs=inputs,
        outputs={"ViterbiPath": [path]},
    )
    return path


def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None, name=None):
    """CTC loss [B, 1] over dense [B, T, V] logits (warpctc_op.cc)."""
    helper = LayerHelper("warpctc", name=name)
    loss = helper.create_variable_for_type_inference(input.dtype)
    grad = helper.create_variable_for_type_inference(
        input.dtype, stop_gradient=True
    )
    inputs = {"Logits": [input], "Label": [label]}
    if input_length is not None:
        inputs["LogitsLength"] = [input_length]
    if label_length is not None:
        inputs["LabelLength"] = [label_length]
    helper.append_op(
        type="warpctc",
        inputs=inputs,
        outputs={"Loss": [loss], "WarpCTCGrad": [grad]},
        attrs={"blank": int(blank), "norm_by_times": bool(norm_by_times)},
    )
    return loss


def ctc_greedy_decoder(input, blank, input_length=None, name=None):
    """Argmax over classes then CTC collapse (ctc_align_op.cc). ``input``
    is [B, T, V] probabilities/logits; returns (paths [B, T], lengths)."""
    from paddle_tpu_torch.layers import nn as nn_layers

    _, ids = nn_layers.topk(input, k=1)
    ids = nn_layers.reshape(ids, shape=[0, -1])  # [B, T]
    helper = LayerHelper("ctc_align", name=name)
    out = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True
    )
    out_len = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True
    )
    inputs = {"Input": [ids]}
    if input_length is not None:
        inputs["InputLength"] = [input_length]
    helper.append_op(
        type="ctc_align",
        inputs=inputs,
        outputs={"Output": [out], "OutputLength": [out_len]},
        attrs={"blank": int(blank), "merge_repeated": True},
    )
    return out, out_len


def edit_distance(input, label, normalized=True, input_length=None,
                  label_length=None, name=None):
    """Levenshtein distance per pair [B, 1] + sequence count."""
    helper = LayerHelper("edit_distance", name=name)
    out = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True
    )
    seq_num = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True
    )
    inputs = {"Hyps": [input], "Refs": [label]}
    if input_length is not None:
        inputs["HypsLength"] = [input_length]
    if label_length is not None:
        inputs["RefsLength"] = [label_length]
    helper.append_op(
        type="edit_distance",
        inputs=inputs,
        outputs={"Out": [out], "SequenceNum": [seq_num]},
        attrs={"normalized": bool(normalized)},
    )
    return out, seq_num


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, length=None, name=None):
    """Chunk P/R/F1 (chunk_eval_op.cc). Returns (precision, recall, f1,
    num_infer, num_label, num_correct)."""
    helper = LayerHelper("chunk_eval", name=name)
    precision = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True
    )
    recall = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True
    )
    f1 = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True
    )
    num_infer = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True
    )
    num_label = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True
    )
    num_correct = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True
    )
    inputs = {"Inference": [input], "Label": [label]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="chunk_eval",
        inputs=inputs,
        outputs={
            "Precision": [precision],
            "Recall": [recall],
            "F1-Score": [f1],
            "NumInferChunks": [num_infer],
            "NumLabelChunks": [num_label],
            "NumCorrectChunks": [num_correct],
        },
        attrs={
            "num_chunk_types": int(num_chunk_types),
            "chunk_scheme": chunk_scheme,
            "excluded_chunk_types": list(excluded_chunk_types or []),
        },
    )
    return precision, recall, f1, num_infer, num_label, num_correct


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None, name=None,
        sampler="uniform", seed=0, is_sparse=False):
    """Noise-contrastive estimation cost [B, 1] (nce_op.cc)."""
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dim = int(input.shape[-1])
    num_neg_samples = int(num_neg_samples or 10)
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[num_total_classes, dim],
        dtype=input.dtype,
    )
    inputs = {"Input": [input], "Label": [label], "Weight": [w]}
    if helper.bias_attr is not False:
        b = helper.create_parameter(
            attr=helper.bias_attr, shape=[num_total_classes, 1],
            dtype=input.dtype, is_bias=True,
        )
        inputs["Bias"] = [b]
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight]
    cost = helper.create_variable_for_type_inference(input.dtype)
    sample_logits = helper.create_variable_for_type_inference(input.dtype)
    sample_labels = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True
    )
    helper.append_op(
        type="nce",
        inputs=inputs,
        outputs={
            "Cost": [cost],
            "SampleLogits": [sample_logits],
            "SampleLabels": [sample_labels],
        },
        attrs={
            "num_total_classes": int(num_total_classes),
            "num_neg_samples": num_neg_samples,
            "sampler": {"uniform": 0, "log_uniform": 1,
                        "custom_dist": 2}.get(sampler, 0),
            "seed": seed,
            "is_sparse": is_sparse,
        },
    )
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """Hierarchical-sigmoid cost [B, 1] over a complete binary class tree
    (hierarchical_sigmoid_op.cc / math/matrix_bit_code)."""
    helper = LayerHelper("hsigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = int(input.shape[-1])
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[num_classes - 1, dim],
        dtype=input.dtype,
    )
    inputs = {"X": [input], "W": [w], "Label": [label]}
    if helper.bias_attr is not False:
        b = helper.create_parameter(
            attr=helper.bias_attr, shape=[num_classes - 1, 1],
            dtype=input.dtype, is_bias=True,
        )
        inputs["Bias"] = [b]
    out = helper.create_variable_for_type_inference(input.dtype)
    pre_out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="hierarchical_sigmoid",
        inputs=inputs,
        outputs={"Out": [out], "PreOut": [pre_out]},
        attrs={"num_classes": int(num_classes)},
    )
    return out
