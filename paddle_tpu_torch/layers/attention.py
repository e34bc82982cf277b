"""Attention layers: scaled dot-product, multi-head, the paged-decode
family, the speculative verify family and the mixture-of-experts FFN.

Counterpart of ``paddle_tpu/layers/attention.py`` for the layers this
slice calls, with the reference's names and signatures.
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = [
    "scaled_dot_product_attention",
    "multi_head_attention",
    "paged_attention",
    "paged_kv_write",
    "paged_kv_prefill",
    "paged_copy_page",
    "paged_tree_attention",
    "paged_spec_kv_write",
    "paged_spec_kv_compact",
    "grouped_cross_attention",
    "slot_decode_sample",
    "slot_beam_search",
    "slot_speculative_accept",
    "add_position_encoding",
    "moe_ffn",
]


def scaled_dot_product_attention(queries, keys, values, mask=None,
                                 causal=False, sm_scale=None, impl="auto",
                                 seq_parallel_axis=None, kv_group=1,
                                 window=0, name=None):
    """Fused attention over [batch, heads, seq, head_dim] tensors."""
    helper = LayerHelper("sdpa", name=name)
    out = helper.create_variable_for_type_inference(queries.dtype)
    inputs = {"Q": [queries], "K": [keys], "V": [values]}
    if mask is not None:
        inputs["Mask"] = [mask]
    helper.append_op(
        type="scaled_dot_product_attention",
        inputs=inputs,
        outputs={"Out": [out]},
        attrs={"causal": causal, "sm_scale": float(sm_scale or 0.0),
               "impl": impl, "seq_parallel_axis": seq_parallel_axis or "",
               "kv_group": int(kv_group), "window": int(window)},
    )
    return out


def multi_head_attention(queries, keys, values, d_key, d_value, d_model,
                         n_head=1, n_kv_head=None, dropout_rate=0.0,
                         mask=None, causal=False, param_attr=None,
                         is_test=False, name=None):
    """Projections + fused attention + output projection.
    queries/keys/values: [batch, seq, d_model]; returns
    [batch, seq, d_model]. ``n_kv_head`` is grouped-query attention.
    ``dropout_rate`` applies ``dropout`` to the merged heads ahead of the
    output projection, as the reference does."""
    from paddle_tpu_torch.layers import nn as nn_layers

    if keys is None:
        keys = queries
    if values is None:
        values = keys
    kv_heads = n_head if n_kv_head is None else int(n_kv_head)
    if kv_heads < 1 or n_head % kv_heads != 0:
        raise ValueError(
            "multi_head_attention: n_kv_head (%d) must be >= 1 and "
            "divide n_head (%d)" % (kv_heads, n_head))

    def proj(x, size, suffix):
        return nn_layers.fc(input=x, size=size, num_flatten_dims=2,
                            bias_attr=False, param_attr=param_attr,
                            name=(name + suffix) if name else None)

    q = proj(queries, d_key * n_head, "_q")
    k = proj(keys, d_key * kv_heads, "_k")
    v = proj(values, d_value * kv_heads, "_v")

    def split_heads(x, d_head, heads):
        # [B, T, H*dh] -> [B, H, T, dh]
        return nn_layers.transpose(
            nn_layers.reshape(x, shape=[0, 0, heads, d_head]),
            perm=[0, 2, 1, 3])

    ctx = scaled_dot_product_attention(
        split_heads(q, d_key, n_head), split_heads(k, d_key, kv_heads),
        split_heads(v, d_value, kv_heads), mask=mask, causal=causal,
        sm_scale=d_key ** -0.5, kv_group=n_head // kv_heads)
    merged = nn_layers.reshape(
        nn_layers.transpose(ctx, perm=[0, 2, 1, 3]),
        shape=[0, 0, n_head * d_value])
    if dropout_rate:
        merged = nn_layers.dropout(merged, dropout_prob=dropout_rate,
                                   is_test=is_test)
    return proj(merged, d_model, "_o")


def paged_attention(query, k_pool, v_pool, page_table, lengths,
                    sm_scale=None, impl="auto", name=None):
    """Ragged paged-attention decode: ``query`` [S, H, 1, dh], pools
    [num_pages, H, page_size, dh], ``page_table`` [S, pages_per_slot],
    ``lengths`` [S] (or [S, 1]) resident tokens per slot."""
    helper = LayerHelper("paged_attention", name=name)
    out = helper.create_variable_for_type_inference(query.dtype)
    helper.append_op(
        type="paged_attention",
        inputs={"Q": [query], "KPool": [k_pool], "VPool": [v_pool],
                "PageTable": [page_table], "Lengths": [lengths]},
        outputs={"Out": [out]},
        attrs={"sm_scale": float(sm_scale or 0.0), "impl": impl},
    )
    return out


def paged_kv_write(k_pool, v_pool, k_new, v_new, page_table, pos,
                   name=None):
    """O(page) KV-pool write of each slot's new [S, H, 1, dh] row at
    (``page_table[s, pos // page_size]``, ``pos % page_size``). Binds
    ``KOut``/``VOut`` back onto the pool vars (in-place state)."""
    helper = LayerHelper("paged_kv_write", name=name)
    helper.append_op(
        type="paged_kv_write",
        inputs={"KPool": [k_pool], "VPool": [v_pool], "KNew": [k_new],
                "VNew": [v_new], "PageTable": [page_table], "Pos": [pos]},
        outputs={"KOut": [k_pool], "VOut": [v_pool]},
    )
    return k_pool, v_pool


def paged_kv_prefill(k_pool, v_pool, k_new, v_new, page_row, write_from,
                     length, name=None):
    """Chunked-prefill KV scatter of a forced prefix's [1, H, T, dh] rows
    into the slot's pages (positions ``write_from <= p < length - 1``;
    the rest route to the trash page). In-place state on the pools."""
    helper = LayerHelper("paged_kv_prefill", name=name)
    helper.append_op(
        type="paged_kv_prefill",
        inputs={"KPool": [k_pool], "VPool": [v_pool], "KNew": [k_new],
                "VNew": [v_new], "PageRow": [page_row],
                "WriteFrom": [write_from], "Len": [length]},
        outputs={"KOut": [k_pool], "VOut": [v_pool]},
    )
    return k_pool, v_pool


def paged_copy_page(k_pool, v_pool, src_page, dst_page, name=None):
    """``pool[dst] = pool[src]`` for the K and V pool (the COW copy).
    In-place state on the pools."""
    helper = LayerHelper("paged_copy_page", name=name)
    helper.append_op(
        type="paged_copy_page",
        inputs={"KPool": [k_pool], "VPool": [v_pool], "Src": [src_page],
                "Dst": [dst_page]},
        outputs={"KOut": [k_pool], "VOut": [v_pool]},
    )
    return k_pool, v_pool


def paged_tree_attention(query, k_pool, v_pool, page_table, base_lens,
                         anc, sm_scale=None, max_length=0, impl="auto",
                         name=None):
    """Speculative tree-verify attention over the paged pool.

    ``query`` [S, H, N, dh]: N speculation-tree nodes per slot, laid out
    linearly in the slot's write pages at storage positions
    ``base .. base + N - 1``; ``base_lens`` [S] (or [S, 1]) committed
    rows per slot (-1 marks a done slot: output exactly 0); ``anc``
    [S, N, N] ancestor mask (diagonal included). Node ``n`` attends every
    committed row plus its own root path."""
    helper = LayerHelper("paged_tree_attention", name=name)
    out = helper.create_variable_for_type_inference(query.dtype)
    helper.append_op(
        type="paged_tree_attention",
        inputs={"Q": [query], "KPool": [k_pool], "VPool": [v_pool],
                "PageTable": [page_table], "BaseLens": [base_lens],
                "Anc": [anc]},
        outputs={"Out": [out]},
        attrs={"sm_scale": float(sm_scale or 0.0), "impl": impl,
               "max_length": int(max_length)},
    )
    return out


def paged_spec_kv_write(k_pool, v_pool, k_new, v_new, page_table, pos,
                        name=None):
    """Tree write of the verify step: all N tree nodes' K/V rows
    ``[S, H, N, dh]`` land at storage positions ``pos[s] .. pos[s] + N -
    1`` through the table (rows past the table's coverage go to the trash
    page). In-place state on the pools."""
    helper = LayerHelper("paged_spec_kv_write", name=name)
    helper.append_op(
        type="paged_spec_kv_write",
        inputs={"KPool": [k_pool], "VPool": [v_pool], "KNew": [k_new],
                "VNew": [v_new], "PageTable": [page_table], "Pos": [pos]},
        outputs={"KOut": [k_pool], "VOut": [v_pool]},
    )
    return k_pool, v_pool


def paged_spec_kv_compact(k_pool, v_pool, page_table, pos, path,
                          accept_len, name=None):
    """Survivor commit of the accepted speculation path: storage row
    ``pos + j`` receives tree node ``path[s, j]``'s K/V row for
    ``1 <= j < accept_len[s]``. In-place state on the pools."""
    helper = LayerHelper("paged_spec_kv_compact", name=name)
    helper.append_op(
        type="paged_spec_kv_compact",
        inputs={"KPool": [k_pool], "VPool": [v_pool],
                "PageTable": [page_table], "Pos": [pos], "Path": [path],
                "AcceptLen": [accept_len]},
        outputs={"KOut": [k_pool], "VOut": [v_pool]},
    )
    return k_pool, v_pool


def grouped_cross_attention(query, k_pool, v_pool, group_of, mask,
                            sm_scale=None, impl="auto", name=None):
    """Group-indexed cross attention for the paged decode step:
    ``query`` [S, H, 1, dh] ([S, H, N, dh] in the verify step); pools [G, H, T_src, dh]; ``group_of`` [S, 1]
    group ids; ``mask`` [G, T_src] validity rows."""
    helper = LayerHelper("grouped_cross_attention", name=name)
    out = helper.create_variable_for_type_inference(query.dtype)
    helper.append_op(
        type="grouped_cross_attention",
        inputs={"Q": [query], "KPool": [k_pool], "VPool": [v_pool],
                "GroupOf": [group_of], "Mask": [mask]},
        outputs={"Out": [out]},
        attrs={"sm_scale": float(sm_scale or 0.0), "impl": impl},
    )
    return out


def slot_decode_sample(logits, pos, done=None, strategy="greedy",
                       temperature=1.0, top_k=0, base_seed=0, eos_id=2,
                       max_length=0, name=None):
    """Per-slot token selection + slot lifecycle step for the decode
    loop. Returns ``(token [S, 1], new_pos [S, 1], new_done [S, 1])``.
    ``max_length`` (the decode budget) is required. ``strategy`` is
    greedy, temperature or top_k (``ops/sampling_ops.py``)."""
    if int(max_length) < 2:
        raise ValueError(
            "slot_decode_sample needs max_length >= 2 (the decode "
            "budget; positions clamp to max_length - 1), got %r"
            % (max_length,))
    if strategy == "top_k" and int(top_k) < 1:
        raise ValueError(
            "slot_decode_sample strategy 'top_k' needs top_k >= 1 — "
            "0 would silently sample the full vocabulary")
    helper = LayerHelper("slot_decode_sample", name=name)
    tok = helper.create_variable_for_type_inference("int64")
    new_pos = helper.create_variable_for_type_inference("int64")
    new_done = helper.create_variable_for_type_inference("int64")
    inputs = {"Logits": [logits], "Pos": [pos]}
    if done is not None:
        inputs["Done"] = [done]
    helper.append_op(
        type="slot_decode_sample",
        inputs=inputs,
        outputs={"Out": [tok], "PosOut": [new_pos], "DoneOut": [new_done]},
        attrs={"strategy": strategy, "temperature": float(temperature),
               "top_k": int(top_k), "base_seed": int(base_seed),
               "eos_id": int(eos_id), "max_length": int(max_length)},
    )
    return tok, new_pos, new_done


def slot_beam_search(logits, tok, pos, done, score, beam_width,
                     eos_id=2, max_length=0, name=None):
    """Batched beam selection and parent gather over the slot pool
    (``ops/beam_search_ops.py`` ``slot_beam_search``): the ``S = B * K``
    slots are K-wide beam lanes, one top-K lattice per lane selects the
    survivors, and each survivor takes its parent's position and done
    state. The session gathers the page-table rows by the returned
    GLOBAL parent indices. Returns ``(token, new_pos, new_done,
    new_score, parent)``, all ``[S, 1]``."""
    if int(beam_width) < 2:
        raise ValueError(
            "slot_beam_search needs beam_width >= 2 (width 1 is "
            "slot_decode_sample's job), got %r" % (beam_width,))
    if int(max_length) < 2:
        raise ValueError(
            "slot_beam_search needs max_length >= 2 (the decode "
            "budget), got %r" % (max_length,))
    helper = LayerHelper("slot_beam_search", name=name)
    tok_out = helper.create_variable_for_type_inference("int64")
    new_pos = helper.create_variable_for_type_inference("int64")
    new_done = helper.create_variable_for_type_inference("int64")
    new_score = helper.create_variable_for_type_inference("float32")
    parent = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="slot_beam_search",
        inputs={"Logits": [logits], "Tok": [tok], "Pos": [pos],
                "Done": [done], "Score": [score]},
        outputs={"Out": [tok_out], "PosOut": [new_pos],
                 "DoneOut": [new_done], "ScoreOut": [new_score],
                 "ParentOut": [parent]},
        attrs={"beam_width": int(beam_width), "eos_id": int(eos_id),
               "max_length": int(max_length)},
    )
    return tok_out, new_pos, new_done, new_score, parent


def slot_speculative_accept(logits, nodes, parent, pos, done,
                            strategy="greedy", temperature=1.0, top_k=0,
                            base_seed=0, eos_id=2, max_length=0,
                            name=None):
    """In-graph accept/reject walk of speculative decoding
    (``ops/speculative_ops.py``): the sequential token rule replayed down
    the speculation tree, committing the longest draft prefix the target
    itself would emit plus one correction or bonus token. ``logits``
    [S, N, V]; ``nodes``/``parent`` [S, N]; returns ``(anchor_tok [S,1],
    tok_seq [S,N], accept_len [S,1], path [S,N], new_pos [S,1],
    new_done [S,1])``."""
    if int(max_length) < 2:
        raise ValueError(
            "slot_speculative_accept needs max_length >= 2 (the decode "
            "budget), got %r" % (max_length,))
    if strategy == "top_k" and int(top_k) < 1:
        raise ValueError(
            "slot_speculative_accept strategy 'top_k' needs top_k >= 1 "
            "— 0 would silently sample the full vocabulary")
    helper = LayerHelper("slot_speculative_accept", name=name)
    anchor = helper.create_variable_for_type_inference("int64")
    tok_seq = helper.create_variable_for_type_inference("int64")
    accept_len = helper.create_variable_for_type_inference("int64")
    path = helper.create_variable_for_type_inference("int64")
    new_pos = helper.create_variable_for_type_inference("int64")
    new_done = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="slot_speculative_accept",
        inputs={"Logits": [logits], "Nodes": [nodes], "Parent": [parent],
                "Pos": [pos], "Done": [done]},
        outputs={"Out": [anchor], "TokSeq": [tok_seq],
                 "AcceptLen": [accept_len], "Path": [path],
                 "PosOut": [new_pos], "DoneOut": [new_done]},
        attrs={"strategy": strategy, "temperature": float(temperature),
               "top_k": int(top_k), "base_seed": int(base_seed),
               "eos_id": int(eos_id), "max_length": int(max_length)},
    )
    return anchor, tok_seq, accept_len, path, new_pos, new_done


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    helper = LayerHelper("add_position_encoding", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="add_position_encoding",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"alpha": float(alpha), "beta": float(beta)},
    )
    return out


def moe_ffn(x, num_experts, d_hidden, top_k=1, capacity_factor=1.25,
            act="gelu", mask=None, param_attr=None, name=None):
    """Mixture-of-Experts feed-forward block (Switch-Transformer style;
    ops/moe_ops.py). x: [batch, seq, d_model]; returns (out, aux_loss):
    add ``aux_loss`` (scaled, typically by 1e-2) to the training loss to
    balance expert load. ``mask`` ([batch, seq] validity, 1 = real
    token) keeps padding out of routing."""
    import copy

    from paddle_tpu_torch import initializer
    from paddle_tpu_torch.param_attr import ParamAttr

    helper = LayerHelper("moe_ffn", param_attr=param_attr, name=name)
    d_model = int(x.shape[-1])
    e, h = int(num_experts), int(d_hidden)

    def _slot_attr(suffix):
        # five distinct parameters: one user-named ParamAttr would alias
        # them all, so the name takes a suffix per slot
        attr = ParamAttr._to_attr(copy.copy(helper.param_attr))
        if getattr(attr, "name", None):
            attr.name = attr.name + "_" + suffix
        return attr

    zero = initializer.Constant(0.0)
    gate_w = helper.create_parameter(
        attr=_slot_attr("gate"), shape=[d_model, e], dtype=x.dtype)
    w1 = helper.create_parameter(
        attr=_slot_attr("w1"), shape=[e, d_model, h], dtype=x.dtype)
    b1 = helper.create_parameter(
        attr=_slot_attr("b1"), shape=[e, h], dtype=x.dtype,
        default_initializer=zero)
    w2 = helper.create_parameter(
        attr=_slot_attr("w2"), shape=[e, h, d_model], dtype=x.dtype)
    b2 = helper.create_parameter(
        attr=_slot_attr("b2"), shape=[e, d_model], dtype=x.dtype,
        default_initializer=zero)
    out = helper.create_variable_for_type_inference(x.dtype)
    aux = helper.create_variable_for_type_inference(x.dtype)
    op_inputs = {"X": [x], "GateW": [gate_w], "ExpertW1": [w1],
                 "ExpertB1": [b1], "ExpertW2": [w2], "ExpertB2": [b2]}
    if mask is not None:
        op_inputs["Mask"] = [mask]
    helper.append_op(
        type="moe_ffn",
        inputs=op_inputs,
        outputs={"Out": [out], "AuxLoss": [aux]},
        attrs={"top_k": int(top_k),
               "capacity_factor": float(capacity_factor), "act": act},
    )
    return out, aux
