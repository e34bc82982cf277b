"""Transformer encoder-decoder for machine translation.

Counterpart of ``paddle_tpu/models/transformer.py`` for the training and
serving slices: the training ``build`` (dropout, label-smoothed loss),
the inference program derived from it and the greedy re-score loop over
it (``build_inference``, ``greedy_generate``: the program a saved
Transformer serves), the position-encoding tables, the dense slot
decoder, the paged slot decoder (greedy) with its speculative verify
program, the draft decoder and the coalesced copy-on-write program.
Every build function mints the reference's variable and parameter
names, so parameters bind by name across the two packages and across
this package's programs.
"""

import numpy as np

import paddle_tpu_torch as fluid
from paddle_tpu_torch import flags, unique_name
from paddle_tpu_torch.kernels.paged_attention import pages_for
from paddle_tpu_torch.ops.sampling_ops import RNG_PARITY_TODO


def _ffn(x, d_model, d_inner, name):
    h = fluid.layers.fc(input=x, size=d_inner, num_flatten_dims=2,
                        act="relu", name=name + "_fc1")
    return fluid.layers.fc(input=h, size=d_model, num_flatten_dims=2,
                           name=name + "_fc2")


def _prenorm(x, name):
    return fluid.layers.layer_norm(x, begin_norm_axis=2, name=name + "_ln")


def _residual(x, y, dropout, is_test, name):
    if dropout:
        y = fluid.layers.dropout(y, dropout_prob=dropout, is_test=is_test)
    return fluid.layers.elementwise_add(x, y)


def _self_attention_block(x, mask, n_head, d_model, dropout, is_test, name):
    attn = fluid.layers.multi_head_attention(
        _prenorm(x, name + "_attn"), None, None,
        d_key=d_model // n_head, d_value=d_model // n_head,
        d_model=d_model, n_head=n_head, mask=mask, is_test=is_test,
        name=name + "_mha")
    return _residual(x, attn, dropout, is_test, name + "_res1")


def encoder_layer(x, mask, n_head, d_model, d_inner, dropout, is_test, name):
    x = _self_attention_block(x, mask, n_head, d_model, dropout, is_test,
                              name)
    ff = _ffn(_prenorm(x, name + "_ffn"), d_model, d_inner, name + "_ffn")
    return _residual(x, ff, dropout, is_test, name + "_res2")


def decoder_layer(x, enc_out, cross_mask, n_head, d_model, d_inner,
                  dropout, is_test, name):
    self_attn = fluid.layers.multi_head_attention(
        _prenorm(x, name + "_sattn"), None, None,
        d_key=d_model // n_head, d_value=d_model // n_head,
        d_model=d_model, n_head=n_head, causal=True, is_test=is_test,
        name=name + "_smha")
    x = _residual(x, self_attn, dropout, is_test, name + "_res1")
    cross = fluid.layers.multi_head_attention(
        _prenorm(x, name + "_cattn"), enc_out, enc_out,
        d_key=d_model // n_head, d_value=d_model // n_head,
        d_model=d_model, n_head=n_head, mask=cross_mask, is_test=is_test,
        name=name + "_cmha")
    x = _residual(x, cross, dropout, is_test, name + "_res2")
    ff = _ffn(_prenorm(x, name + "_ffn"), d_model, d_inner, name + "_ffn")
    return _residual(x, ff, dropout, is_test, name + "_res3")


def build(src_vocab_size=1000, trg_vocab_size=1000, max_length=64,
          n_layer=2, n_head=4, d_model=128, d_inner=512, dropout=0.1,
          label_smooth_eps=0.1, is_test=False):
    """Returns (avg_cost, feeds, extras), as the reference. Feeds:
    src_word [B,S], src_len [B,1], trg_word [B,T], trg_len [B,1],
    label [B,T]. ``FLAGS_fused_ce`` raises: its fused op and the bf16
    casts come with a later slice (ROADMAP.md A3)."""
    if flags.get("fused_ce"):
        raise NotImplementedError(
            "FLAGS_fused_ce: the fused label-smoothed cross entropy is not "
            "ported yet (ROADMAP.md A3)")
    src = fluid.layers.data("src_word", shape=[max_length], dtype="int64")
    src_len = fluid.layers.data("src_len", shape=[1], dtype="int64")
    trg = fluid.layers.data("trg_word", shape=[max_length], dtype="int64")
    label = fluid.layers.data("label", shape=[max_length], dtype="int64")

    src_mask = fluid.layers.sequence_mask(src_len, maxlen=max_length,
                                          dtype="float32")
    src_emb = fluid.layers.embedding(
        input=src, size=[src_vocab_size, d_model],
        param_attr=fluid.ParamAttr(name="src_emb"))
    src_emb = fluid.layers.scale(src_emb, scale=d_model ** 0.5)
    enc_in = fluid.layers.add_position_encoding(src_emb)

    trg_emb = fluid.layers.embedding(
        input=trg, size=[trg_vocab_size, d_model],
        param_attr=fluid.ParamAttr(name="trg_emb"))
    trg_emb = fluid.layers.scale(trg_emb, scale=d_model ** 0.5)
    dec_in = fluid.layers.add_position_encoding(trg_emb)

    enc = enc_in
    for i in range(n_layer):
        enc = encoder_layer(enc, src_mask, n_head, d_model, d_inner,
                            dropout, is_test, "enc_%d" % i)
    enc = _prenorm(enc, "enc_final")

    dec = dec_in
    for i in range(n_layer):
        dec = decoder_layer(dec, enc, src_mask, n_head, d_model, d_inner,
                            dropout, is_test, "dec_%d" % i)
    dec = _prenorm(dec, "dec_final")

    logits = fluid.layers.fc(input=dec, size=trg_vocab_size,
                             num_flatten_dims=2, name="proj_logits")
    flat_logits = fluid.layers.reshape(logits, shape=[-1, trg_vocab_size])
    flat_label = fluid.layers.reshape(label, shape=[-1, 1])
    # smoothed cross entropy in factored form (models/transformer.py:
    # 146-170): (1-eps) * hardCE + (eps/V) * (-sum_i logp_i)
    cost = fluid.layers.softmax_with_cross_entropy(flat_logits, flat_label)
    if label_smooth_eps:
        neg_sum_logp = fluid.layers.scale(
            fluid.layers.reduce_sum(fluid.layers.log_softmax(flat_logits),
                                    dim=-1, keep_dim=True),
            scale=-1.0)
        cost = fluid.layers.elementwise_add(
            fluid.layers.scale(cost, scale=1.0 - label_smooth_eps),
            fluid.layers.scale(neg_sum_logp,
                               scale=label_smooth_eps / trg_vocab_size))

    trg_len = fluid.layers.data("trg_len", shape=[1], dtype="int64")
    trg_mask = fluid.layers.sequence_mask(trg_len, maxlen=max_length,
                                          dtype="float32")
    cost = fluid.layers.reshape(cost, shape=[-1, max_length])
    masked = fluid.layers.elementwise_mul(cost, trg_mask)
    total = fluid.layers.reduce_sum(masked)
    denom = fluid.layers.reduce_sum(trg_mask)
    avg_cost = fluid.layers.elementwise_div(total, denom)
    feeds = [src, src_len, trg, trg_len, label]
    return avg_cost, feeds, {"logits": logits}


def build_inference(train_prog, logits):
    """The generation graph of the TRAINED program (transformer.py:196):
    a clone with is_test set, pruned to the logits fetch, so the loss
    head, backward and optimizer ops fall away and running it cannot
    touch the weights, which bind through the shared scope."""
    from paddle_tpu_torch import io

    return io.prune_program(
        train_prog.clone(for_test=True),
        ["src_word", "src_len", "trg_word"],
        [logits.name if hasattr(logits, "name") else logits])


def greedy_generate(exe, infer_prog, logits_var, src, src_len, max_length,
                    bos_id=1, eos_id=2, scope=None):
    """Greedy decode by re-running the whole fixed-shape decoder over the
    growing prefix (transformer.py:211, the reference's re-score loop).
    Returns [B, max_length] int64, eos-padded."""
    bs = src.shape[0]
    trg = np.full((bs, max_length), eos_id, np.int64)
    trg[:, 0] = bos_id
    done = np.zeros(bs, bool)
    for t in range(max_length - 1):
        (lg,) = exe.run(infer_prog, feed={"src_word": src,
                                          "src_len": src_len,
                                          "trg_word": trg},
                        fetch_list=[logits_var], scope=scope)
        nxt = np.where(done, eos_id, np.asarray(lg)[:, t, :].argmax(-1))
        trg[:, t + 1] = nxt
        done |= nxt == eos_id
        if done.all():
            break
    return trg


def position_encoding_row(t, d_model, dtype="float32"):
    """Host mirror of the add_position_encoding table's row ``t``."""
    i = np.arange(d_model // 2, dtype=np.float64)
    angle = float(t) / np.power(10000.0, 2.0 * i / d_model)
    return np.concatenate([np.sin(angle), np.cos(angle)]).astype(
        dtype)[None, :]


def position_encoding_table(max_length, d_model, dtype="float32"):
    """The full [max_length, d_model] sinusoid table, row-exact with
    ``position_encoding_row``; fed once to the paged decoder's init
    program."""
    return np.concatenate(
        [position_encoding_row(t, d_model, dtype=dtype)
         for t in range(int(max_length))], axis=0)


def _check_greedy(sampler):
    """The port decodes greedily; any stochastic sampler needs the
    RNG-parity item first (ROADMAP.md A6)."""
    if sampler is None:
        return
    if isinstance(sampler, dict):
        strategy = sampler.get("strategy", "greedy")
        temperature = float(sampler.get("temperature", 1.0))
    else:
        strategy = getattr(sampler, "strategy", "greedy")
        temperature = float(getattr(sampler, "temperature", 1.0))
    if strategy not in ("greedy", "temperature", "top_k"):
        raise ValueError("sampler strategy must be greedy/temperature/"
                         "top_k, got %r" % (strategy,))
    if strategy != "greedy" and temperature > 0.0:
        raise NotImplementedError(RNG_PARITY_TODO)


def build_slot_decoder(num_slots, src_vocab_size=1000, trg_vocab_size=1000,
                       max_length=64, n_layer=2, n_head=4, d_model=128,
                       d_inner=512, eos_id=2, sampler=None):
    """Continuous-batching decode over DENSE slot caches (greedy).

    Returns ``(init_prog, admit_prog, step_prog, token_name)`` exactly as
    the reference (``paddle_tpu/models/transformer.py``
    ``build_slot_decoder``):

    * ``init_prog`` (once): zeroed per-layer self K/V caches
      ``[num_slots, H, T, dh]``, cross K/V pools of the same shape, and
      the per-slot source mask ``[num_slots, T]`` (column 0 valid, so an
      unoccupied slot's cross attention never sees a wholly masked row).
    * ``admit_prog`` (per admission): the encoder over ONE sequence
      (``src_word [1, T]``, ``src_len [1, 1]``, ``slot_idx [1]``), its
      cross K/V and mask scattered into the slot's rows and the slot's
      self caches zeroed, all by ``dynamic_update_slice`` on the slot
      axis.
    * ``step_prog`` (per token): feeds ``cur_tok [S, 1]``,
      ``pe_row [S, 1, D]`` and ``gen_pos [S, 1]`` (per-slot positions).
      Each slot's new K/V row lands at its own position by a one-hot
      select-and-add (written positions get exactly the new row, others
      keep their bits), attention is ``scaled_dot_product_attention``
      over the whole ``[S, H, T, dh]`` cache with a per-slot ``[S, T]``
      key mask (on the card the flash kernel's rows path at T = 1), and
      the fetch is the ``[S, 1]`` token ids.

    Stochastic samplers raise until ROADMAP.md A6. Build it under the
    training ``build()``'s fresh ``unique_name`` scope; parameters bind
    by name."""
    _check_greedy(sampler)
    nn = fluid.layers
    S, T, D = int(num_slots), int(max_length), int(d_model)
    dh = D // n_head

    def heads(x):
        return nn.transpose(nn.reshape(x, shape=[0, 0, n_head, dh]),
                            perm=[0, 2, 1, 3])

    def merge(x):
        return nn.reshape(nn.transpose(x, perm=[0, 2, 1, 3]),
                          shape=[0, 0, n_head * dh])

    def proj(x, size, name):
        return nn.fc(x, size, num_flatten_dims=2, bias_attr=False, name=name)

    with unique_name.guard({}):
        init = fluid.Program()
        with fluid.program_guard(init, fluid.Program()):
            blk = init.global_block()

            def persist(name, value):
                out = blk.create_var(name=name, shape=None,
                                     dtype="float32", persistable=True)
                nn.assign(value, output=out)

            mask0 = nn.fill_constant([S, T], "float32", 0.0)
            mask0 = nn.dynamic_update_slice(
                mask0, nn.fill_constant([S, 1], "float32", 1.0),
                nn.fill_constant([1], "int64", 0), axis=1)
            persist("gen_src_mask", mask0)
            for i in range(n_layer):
                for kind in ("kcross", "vcross", "kcache", "vcache"):
                    persist("gen_%s_%d" % (kind, i),
                            nn.fill_constant([S, n_head, T, dh],
                                             "float32", 0.0))

        admit = fluid.Program()
        with fluid.program_guard(admit, fluid.Program()):
            blk = admit.global_block()
            src = nn.data("src_word", shape=[T], dtype="int64")
            src_len = nn.data("src_len", shape=[1], dtype="int64")
            slot = nn.data("slot_idx", shape=[1], dtype="int64",
                           append_batch_size=False)
            src_mask = nn.sequence_mask(src_len, maxlen=T,
                                        dtype="float32")  # [1, T]
            emb = nn.embedding(input=src, size=[src_vocab_size, D],
                               param_attr=fluid.ParamAttr(name="src_emb"))
            enc = nn.add_position_encoding(nn.scale(emb, scale=D ** 0.5))
            for i in range(n_layer):
                enc = encoder_layer(enc, src_mask, n_head, D, d_inner,
                                    0.0, True, "enc_%d" % i)
            enc = _prenorm(enc, "enc_final")

            def pool(name):
                return blk.create_var(name=name, shape=[S, n_head, T, dh],
                                      dtype="float32", persistable=True)

            mask_pool = blk.create_var(name="gen_src_mask", shape=[S, T],
                                       dtype="float32", persistable=True)
            nn.dynamic_update_slice(mask_pool, src_mask, slot, axis=0,
                                    out=mask_pool)
            zeros_row = nn.fill_constant([1, n_head, T, dh], "float32", 0.0)
            for i in range(n_layer):
                kc = heads(proj(enc, dh * n_head, "dec_%d_cmha_k" % i))
                vc = heads(proj(enc, dh * n_head, "dec_%d_cmha_v" % i))
                for pname, row in (("gen_kcross_%d" % i, kc),
                                   ("gen_vcross_%d" % i, vc),
                                   ("gen_kcache_%d" % i, zeros_row),
                                   ("gen_vcache_%d" % i, zeros_row)):
                    p = pool(pname)
                    nn.dynamic_update_slice(p, row, slot, axis=0, out=p)

        step = fluid.Program()
        with fluid.program_guard(step, fluid.Program()):
            blk = step.global_block()
            cur = nn.data("cur_tok", shape=[1], dtype="int64")
            pe_row = nn.data("pe_row", shape=[1, D], dtype="float32")
            pos = nn.data("gen_pos", shape=[1], dtype="int64")  # [S, 1]
            # per-slot validity: positions <= this slot's own pos
            cache_mask = nn.sequence_mask(
                fluid.layers.increment(pos, value=1, in_place=False),
                maxlen=T, dtype="float32")  # [S, T]
            # one-hot of each slot's write position on the cache's T
            # axis: [S, 1, T, 1]
            write_sel = nn.reshape(nn.one_hot(pos, depth=T),
                                   shape=[-1, 1, T, 1])
            keep_sel = nn.scale(write_sel, scale=-1.0, bias=1.0)

            def pvar(name, shape):
                return blk.create_var(name=name, shape=shape,
                                      dtype="float32", persistable=True)

            src_mask = pvar("gen_src_mask", [S, T])
            emb = nn.embedding(input=cur, size=[trg_vocab_size, D],
                               param_attr=fluid.ParamAttr(name="trg_emb"))
            emb = nn.reshape(emb, shape=[0, 1, D])
            h = nn.elementwise_add(nn.scale(emb, scale=D ** 0.5), pe_row)
            for i in range(n_layer):
                name = "dec_%d" % i
                kcache = pvar("gen_kcache_%d" % i, [S, n_head, T, dh])
                vcache = pvar("gen_vcache_%d" % i, [S, n_head, T, dh])
                nx = _prenorm(h, name + "_sattn")
                q = heads(proj(nx, dh * n_head, name + "_smha_q"))
                k1 = heads(proj(nx, dh * n_head, name + "_smha_k"))
                v1 = heads(proj(nx, dh * n_head, name + "_smha_v"))
                # per-slot scatter: row i writes at ITS gen_pos[i]; the
                # select-and-add keeps untouched positions bit-identical
                knew = nn.elementwise_add(
                    nn.elementwise_mul(kcache, keep_sel),
                    nn.elementwise_mul(k1, write_sel))
                vnew = nn.elementwise_add(
                    nn.elementwise_mul(vcache, keep_sel),
                    nn.elementwise_mul(v1, write_sel))
                nn.assign(knew, output=kcache)
                nn.assign(vnew, output=vcache)
                att = fluid.layers.scaled_dot_product_attention(
                    q, knew, vnew, mask=cache_mask, sm_scale=dh ** -0.5)
                h = nn.elementwise_add(
                    h, proj(merge(att), D, name + "_smha_o"))
                nx2 = _prenorm(h, name + "_cattn")
                q2 = heads(proj(nx2, dh * n_head, name + "_cmha_q"))
                ctx = fluid.layers.scaled_dot_product_attention(
                    q2, pvar("gen_kcross_%d" % i, [S, n_head, T, dh]),
                    pvar("gen_vcross_%d" % i, [S, n_head, T, dh]),
                    mask=src_mask, sm_scale=dh ** -0.5)
                h = nn.elementwise_add(
                    h, proj(merge(ctx), D, name + "_cmha_o"))
                ff = _ffn(_prenorm(h, name + "_ffn"), D, d_inner,
                          name + "_ffn")
                h = nn.elementwise_add(h, ff)
            h = _prenorm(h, "dec_final")
            logits = nn.fc(h, trg_vocab_size, num_flatten_dims=2,
                           name="proj_logits")
            tok, _, _ = fluid.layers.slot_decode_sample(
                logits, pos, eos_id=eos_id, max_length=T)
    return init, admit, step, tok.name


def build_paged_slot_decoder(num_slots, src_vocab_size=1000,
                             trg_vocab_size=1000, max_length=64, n_layer=2,
                             n_head=4, d_model=128, d_inner=512, page_size=8,
                             num_pages=None, num_groups=None, bos_id=1,
                             eos_id=2, sampler=None, beam_width=1,
                             speculative=0):
    """Block-paged continuous-batching decode (greedy). The slots' self
    K/V live in a page pool ``[num_pages, H, page_size, dh]`` shared
    through a per-slot page table; cross K/V are pooled per group
    ``[num_groups, H, T, dh]``; the step program is a self-contained
    loop body (token choice, position advance and the next token's
    embedding all in the program), so ``Executor.run_multi_step`` runs K
    decode tokens per call.

    Returns ``(init_prog, admit_prog, join_prog, prefill_prog,
    table_prog, step_prog, token_name)`` exactly as the reference (see
    its docstring for each program's feeds).

    ``speculative=K`` (K >= 1) ALSO builds the verify program, the
    tree-attention dispatch that scores the anchor plus K host-drafted
    tokens in one target forward and commits the longest accepted prefix
    in the program. ``spec_step_prog`` feeds ``spec_draft [S, K]`` draft
    tokens, ``spec_parent [S, N]`` tree parents and ``spec_anc [S, N, N]``
    ancestor mask (N = K + 1, node 0 the anchor). It embeds all N nodes
    at their LOGICAL positions (``pos + depth``), writes every node's K/V
    into the slot's write pages at storage ``pos .. pos + N - 1``
    (``paged_spec_kv_write``; done slots go to the trash page), runs
    ``paged_tree_attention``, then ``slot_speculative_accept`` and one
    ``paged_spec_kv_compact`` per layer. The return value grows to
    ``(init, admit, join, prefill, table, step, spec_step, fetches)``
    with ``fetches = {"token", "spec_token_seq", "spec_accept_len"}``;
    the plain ``step_prog`` stays as the ``FLAGS_speculative=off`` oracle.

    Beam decode (``beam_width > 1``, ROADMAP.md A7) and stochastic
    samplers (ROADMAP.md A6) raise here. Build under the training
    ``build()``'s fresh ``unique_name`` scope; parameters bind by
    name."""
    if int(beam_width) != 1:
        raise NotImplementedError(
            "beam decode (beam_width > 1) is not ported yet (ROADMAP.md "
            "A7: ops/beam_search_ops.py and the lane-tiled session)")
    n_spec = int(speculative)
    if n_spec < 0:
        raise ValueError("speculative must be >= 0, got %d" % n_spec)
    _check_greedy(sampler)
    nn = fluid.layers
    S, T, D = int(num_slots), int(max_length), int(d_model)
    dh = D // n_head
    ps = int(page_size)
    npp = pages_for(T, ps)
    P = int(num_pages) if num_pages else 1 + S * npp
    G = int(num_groups) if num_groups else S

    def heads(x):
        return nn.transpose(nn.reshape(x, shape=[0, 0, n_head, dh]),
                            perm=[0, 2, 1, 3])

    def merge(x):
        return nn.reshape(nn.transpose(x, perm=[0, 2, 1, 3]),
                          shape=[0, 0, n_head * dh])

    def proj(x, size, name):
        return nn.fc(x, size, num_flatten_dims=2, bias_attr=False, name=name)

    def pvar_of(blk):
        def pvar(name, shape, dtype="float32"):
            return blk.create_var(name=name, shape=shape, dtype=dtype,
                                  persistable=True)

        return pvar

    def decode_stack(pvar, h, group_of, src_mask, self_attend):
        """The decoder layers over ``h`` ``[S, n, D]`` (n = 1 in the step
        program, the tree's N in the verify program) and the logits
        projection. ``self_attend(q, k1, v1, kpool, vpool)`` writes the
        new K/V rows into the layer's pools and attends over them."""
        for i in range(n_layer):
            name = "dec_%d" % i
            kpool = pvar("pgd_kpool_%d" % i, [P, n_head, ps, dh])
            vpool = pvar("pgd_vpool_%d" % i, [P, n_head, ps, dh])
            nx = _prenorm(h, name + "_sattn")
            q = heads(proj(nx, dh * n_head, name + "_smha_q"))
            k1 = heads(proj(nx, dh * n_head, name + "_smha_k"))
            v1 = heads(proj(nx, dh * n_head, name + "_smha_v"))
            att = self_attend(q, k1, v1, kpool, vpool)
            h = nn.elementwise_add(
                h, proj(merge(att), D, name + "_smha_o"))
            nx2 = _prenorm(h, name + "_cattn")
            q2 = heads(proj(nx2, dh * n_head, name + "_cmha_q"))
            ctx = fluid.layers.grouped_cross_attention(
                q2, pvar("pgd_kcross_%d" % i, [G, n_head, T, dh]),
                pvar("pgd_vcross_%d" % i, [G, n_head, T, dh]),
                group_of, src_mask, sm_scale=dh ** -0.5)
            h = nn.elementwise_add(
                h, proj(merge(ctx), D, name + "_cmha_o"))
            ff = _ffn(_prenorm(h, name + "_ffn"), D, d_inner, name + "_ffn")
            h = nn.elementwise_add(h, ff)
        h = _prenorm(h, "dec_final")
        return nn.fc(h, trg_vocab_size, num_flatten_dims=2,
                     name="proj_logits")

    with unique_name.guard({}):
        init = fluid.Program()
        with fluid.program_guard(init, fluid.Program()):
            blk = init.global_block()

            def persist(name, value, dtype="float32"):
                out = blk.create_var(name=name, shape=None, dtype=dtype,
                                     persistable=True)
                nn.assign(value, output=out)

            pe = nn.data("pe_table", shape=[T, D], dtype="float32",
                         append_batch_size=False)
            persist("pgd_pe_table", pe)
            mask0 = nn.fill_constant([G, T], "float32", 0.0)
            mask0 = nn.dynamic_update_slice(
                mask0, nn.fill_constant([G, 1], "float32", 1.0),
                nn.fill_constant([1], "int64", 0), axis=1)
            persist("pgd_src_mask", mask0)
            for i in range(n_layer):
                for kind in ("kcross", "vcross"):
                    persist("pgd_%s_%d" % (kind, i), nn.fill_constant(
                        [G, n_head, T, dh], "float32", 0.0))
                for kind in ("kpool", "vpool"):
                    persist("pgd_%s_%d" % (kind, i), nn.fill_constant(
                        [P, n_head, ps, dh], "float32", 0.0))
            persist("pgd_group_of",
                    nn.fill_constant([S, 1], "int64", 0), "int64")
            persist("pgd_table",
                    nn.fill_constant([S, npp], "int64", 0), "int64")
            persist("pgd_pos",
                    nn.fill_constant([S, 1], "int64", 0), "int64")
            persist("pgd_tok",
                    nn.fill_constant([S, 1], "int64", bos_id), "int64")
            persist("pgd_done",
                    nn.fill_constant([S, 1], "int64", 1), "int64")

        def slot_state_feeds():
            """The feeds admit/join share for one member's registration."""
            slot = nn.data("slot_idx", shape=[1], dtype="int64",
                           append_batch_size=False)
            gidx = nn.data("group_idx", shape=[1], dtype="int64",
                           append_batch_size=False)
            page_row = nn.data("page_row", shape=[npp], dtype="int64")
            start_tok = nn.data("start_tok", shape=[1], dtype="int64")
            start_pos = nn.data("start_pos", shape=[1], dtype="int64")
            return slot, gidx, page_row, start_tok, start_pos

        def register_member(blk, slot, gidx, page_row, start_tok,
                            start_pos):
            """Install one slot's group id, table row and loop state."""
            def srow(name, value):
                p = blk.create_var(
                    name=name,
                    shape=[S, npp] if name == "pgd_table" else [S, 1],
                    dtype="int64", persistable=True)
                nn.dynamic_update_slice(p, value, slot, axis=0, out=p)

            srow("pgd_group_of", nn.reshape(gidx, shape=[1, 1]))
            srow("pgd_table", page_row)
            srow("pgd_tok", start_tok)
            srow("pgd_pos", start_pos)
            srow("pgd_done", nn.fill_constant([1, 1], "int64", 0))

        admit = fluid.Program()
        with fluid.program_guard(admit, fluid.Program()):
            blk = admit.global_block()
            src = nn.data("src_word", shape=[T], dtype="int64")
            src_len = nn.data("src_len", shape=[1], dtype="int64")
            member_feeds = slot_state_feeds()
            gidx = member_feeds[1]
            src_mask = nn.sequence_mask(src_len, maxlen=T, dtype="float32")
            emb = nn.embedding(input=src, size=[src_vocab_size, D],
                               param_attr=fluid.ParamAttr(name="src_emb"))
            enc = nn.add_position_encoding(nn.scale(emb, scale=D ** 0.5))
            for i in range(n_layer):
                enc = encoder_layer(enc, src_mask, n_head, D, d_inner,
                                    0.0, True, "enc_%d" % i)
            enc = _prenorm(enc, "enc_final")

            def grow(name, shape, value):
                p = blk.create_var(name=name, shape=shape, dtype="float32",
                                   persistable=True)
                nn.dynamic_update_slice(p, value, gidx, axis=0, out=p)

            grow("pgd_src_mask", [G, T], src_mask)
            for i in range(n_layer):
                kc = heads(proj(enc, dh * n_head, "dec_%d_cmha_k" % i))
                vc = heads(proj(enc, dh * n_head, "dec_%d_cmha_v" % i))
                grow("pgd_kcross_%d" % i, [G, n_head, T, dh], kc)
                grow("pgd_vcross_%d" % i, [G, n_head, T, dh], vc)
            register_member(blk, *member_feeds)

        join = fluid.Program()
        with fluid.program_guard(join, fluid.Program()):
            register_member(join.global_block(), *slot_state_feeds())

        prefill = fluid.Program()
        # a FRESH name scope: the prefill program re-creates the
        # decoder's parameter-owning layers exactly as the step program
        # will, and both must get the training build's .w_0/.w_1 names
        with unique_name.guard({}), \
                fluid.program_guard(prefill, fluid.Program()):
            pvar = pvar_of(prefill.global_block())
            pword = nn.data("prefix_word", shape=[T], dtype="int64")
            plen = nn.data("prefix_len", shape=[1], dtype="int64")
            wfrom = nn.data("write_from", shape=[1], dtype="int64")
            slot = nn.data("slot_idx", shape=[1], dtype="int64",
                           append_batch_size=False)
            gidx = nn.data("group_idx", shape=[1], dtype="int64",
                           append_batch_size=False)
            row = nn.gather(pvar("pgd_table", [S, npp], "int64"), slot)
            mask_row = nn.gather(pvar("pgd_src_mask", [G, T]), gidx)
            pe_all = nn.reshape(pvar("pgd_pe_table", [T, D]),
                                shape=[1, T, D])
            emb = nn.embedding(input=pword, size=[trg_vocab_size, D],
                               param_attr=fluid.ParamAttr(name="trg_emb"))
            h = nn.elementwise_add(nn.scale(emb, scale=D ** 0.5), pe_all)
            for i in range(n_layer):
                name = "dec_%d" % i
                kpool = pvar("pgd_kpool_%d" % i, [P, n_head, ps, dh])
                vpool = pvar("pgd_vpool_%d" % i, [P, n_head, ps, dh])
                nx = _prenorm(h, name + "_sattn")
                k1 = heads(proj(nx, dh * n_head, name + "_smha_k"))
                v1 = heads(proj(nx, dh * n_head, name + "_smha_v"))
                # every layer's K/V for the whole prefix lands in one op
                fluid.layers.paged_kv_prefill(kpool, vpool, k1, v1, row,
                                              wfrom, plen)
                if i == n_layer - 1:
                    break  # nothing deeper reads the rest of this block
                q = heads(proj(nx, dh * n_head, name + "_smha_q"))
                att = fluid.layers.scaled_dot_product_attention(
                    q, k1, v1, causal=True, sm_scale=dh ** -0.5)
                h = nn.elementwise_add(
                    h, proj(merge(att), D, name + "_smha_o"))
                nx2 = _prenorm(h, name + "_cattn")
                q2 = heads(proj(nx2, dh * n_head, name + "_cmha_q"))
                kc = nn.gather(pvar("pgd_kcross_%d" % i,
                                    [G, n_head, T, dh]), gidx)
                vc = nn.gather(pvar("pgd_vcross_%d" % i,
                                    [G, n_head, T, dh]), gidx)
                ctx = fluid.layers.scaled_dot_product_attention(
                    q2, kc, vc, mask=mask_row, sm_scale=dh ** -0.5)
                h = nn.elementwise_add(
                    h, proj(merge(ctx), D, name + "_cmha_o"))
                ff = _ffn(_prenorm(h, name + "_ffn"), D, d_inner,
                          name + "_ffn")
                h = nn.elementwise_add(h, ff)

        table = fluid.Program()
        with fluid.program_guard(table, fluid.Program()):
            blk = table.global_block()
            slot = nn.data("slot_idx", shape=[1], dtype="int64",
                           append_batch_size=False)
            page_row = nn.data("page_row", shape=[npp], dtype="int64")
            t = blk.create_var(name="pgd_table", shape=[S, npp],
                               dtype="int64", persistable=True)
            nn.dynamic_update_slice(t, page_row, slot, axis=0, out=t)

        step = fluid.Program()
        with fluid.program_guard(step, fluid.Program()):
            pvar = pvar_of(step.global_block())
            tok = pvar("pgd_tok", [S, 1], "int64")
            pos = pvar("pgd_pos", [S, 1], "int64")
            done = pvar("pgd_done", [S, 1], "int64")
            ptable = pvar("pgd_table", [S, npp], "int64")
            group_of = pvar("pgd_group_of", [S, 1], "int64")
            pe_table = pvar("pgd_pe_table", [T, D])
            src_mask = pvar("pgd_src_mask", [G, T])
            # resident tokens per slot AFTER this step's write: pos + 1
            # for live slots, 0 for done/unoccupied ones (the kernel then
            # reads no page for them)
            live_row = nn.elementwise_sub(
                nn.fill_constant([S, 1], "int64", 1), done)
            lengths = nn.elementwise_mul(
                fluid.layers.increment(pos, value=1, in_place=False),
                live_row)
            emb = nn.embedding(input=tok, size=[trg_vocab_size, D],
                               param_attr=fluid.ParamAttr(name="trg_emb"))
            emb = nn.reshape(emb, shape=[0, 1, D])  # [S, 1, D]
            pe_row = nn.reshape(
                nn.gather(pe_table, nn.reshape(pos, shape=[-1])),
                shape=[0, 1, D])
            h = nn.elementwise_add(nn.scale(emb, scale=D ** 0.5), pe_row)

            def write_and_attend(q, k1, v1, kpool, vpool):
                kpool, vpool = fluid.layers.paged_kv_write(
                    kpool, vpool, k1, v1, ptable, pos)
                return fluid.layers.paged_attention(
                    q, kpool, vpool, ptable, lengths, sm_scale=dh ** -0.5)

            logits = decode_stack(pvar, h, group_of, src_mask,
                                  write_and_attend)
            tok_new, pos_new, done_new = fluid.layers.slot_decode_sample(
                logits, pos, done=done, eos_id=eos_id, max_length=T)
            # thread the loop state: the next iteration embeds the token
            # chosen here, no host in the loop
            nn.assign(tok_new, output=tok)
            nn.assign(pos_new, output=pos)
            nn.assign(done_new, output=done)

        if n_spec:
            Nn = n_spec + 1
            spec = fluid.Program()
            # like prefill: the verify program re-creates the decoder's
            # parameter-owning layers, so a FRESH name scope keeps the
            # .w_0/.w_1 suffixes aligned with the training build
            with unique_name.guard({}), \
                    fluid.program_guard(spec, fluid.Program()):
                pvar = pvar_of(spec.global_block())
                # concrete shapes: the slot axis is fixed at S
                draft = nn.data("spec_draft", shape=[S, n_spec],
                                dtype="int64", append_batch_size=False)
                par = nn.data("spec_parent", shape=[S, Nn], dtype="int64",
                              append_batch_size=False)
                anc = nn.data("spec_anc", shape=[S, Nn, Nn], dtype="int64",
                              append_batch_size=False)
                tok = pvar("pgd_tok", [S, 1], "int64")
                pos = pvar("pgd_pos", [S, 1], "int64")
                done = pvar("pgd_done", [S, 1], "int64")
                ptable = pvar("pgd_table", [S, npp], "int64")
                group_of = pvar("pgd_group_of", [S, 1], "int64")
                pe_table = pvar("pgd_pe_table", [T, D])
                src_mask = pvar("pgd_src_mask", [G, T])
                live_row = nn.elementwise_sub(
                    nn.fill_constant([S, 1], "int64", 1), done)
                # the tree kernel's ragged bound: a LIVE slot's committed
                # storage is [0, pos) and its tree occupies pos .. pos +
                # N - 1; -1 marks a done slot (zero output, no page read)
                base = nn.elementwise_sub(
                    nn.elementwise_mul(
                        fluid.layers.increment(pos, value=1,
                                               in_place=False),
                        live_row),
                    nn.fill_constant([S, 1], "int64", 1))
                # a done slot's whole tree writes to the trash page
                write_table = nn.elementwise_mul(ptable, live_row)
                nodes_tok = nn.concat([tok, draft], axis=1)  # [S, N]
                # depth of node i = |ancestors| - 1 (anc carries the
                # diagonal and the anchor column); its LOGICAL position is
                # pos + depth, clamped into the PE table like the
                # sequential position clamp
                depth = nn.elementwise_sub(
                    nn.reduce_sum(anc, dim=2),
                    nn.fill_constant([1, 1], "int64", 1))
                logical = nn.elementwise_min(
                    nn.elementwise_add(pos, depth),
                    nn.fill_constant([1, 1], "int64", T - 1))
                pe_rows = nn.reshape(
                    nn.gather(pe_table, nn.reshape(logical, shape=[-1])),
                    shape=[S, Nn, D])
                emb = nn.embedding(
                    input=nodes_tok, size=[trg_vocab_size, D],
                    param_attr=fluid.ParamAttr(name="trg_emb"))
                h = nn.elementwise_add(nn.scale(emb, scale=D ** 0.5),
                                       pe_rows)
                spec_pools = []

                def write_and_attend_tree(q, k1, v1, kpool, vpool):
                    kpool, vpool = fluid.layers.paged_spec_kv_write(
                        kpool, vpool, k1, v1, write_table, pos)
                    spec_pools.append((kpool, vpool))
                    return fluid.layers.paged_tree_attention(
                        q, kpool, vpool, ptable, base, anc,
                        sm_scale=dh ** -0.5, max_length=T)

                spec_logits = decode_stack(pvar, h, group_of, src_mask,
                                           write_and_attend_tree)  # [S,N,V]
                (spec_anchor, spec_seq, spec_acc, spec_path, spec_pos,
                 spec_done) = fluid.layers.slot_speculative_accept(
                    spec_logits, nodes_tok, par, pos, done, eos_id=eos_id,
                    max_length=T)
                # survivor commit AFTER the walk (attention read the
                # pre-commit tree layout) and BEFORE the state assigns
                for kpool, vpool in spec_pools:
                    fluid.layers.paged_spec_kv_compact(
                        kpool, vpool, write_table, pos, spec_path, spec_acc)
                nn.assign(spec_anchor, output=tok)
                nn.assign(spec_pos, output=pos)
                nn.assign(spec_done, output=done)
            fetches = {"token": tok_new.name,
                       "spec_token_seq": spec_seq.name,
                       "spec_accept_len": spec_acc.name}
            return init, admit, join, prefill, table, step, spec, fetches
    return init, admit, join, prefill, table, step, tok_new.name


def build_draft_decoder(num_slots, trg_vocab_size=1000, max_length=64,
                        n_head=4, d_model=128, d_inner=None, page_size=8,
                        num_pages=None, eos_id=2):
    """The small DRAFT transformer of speculative decoding: a 1-layer
    decoder-only LM (no cross attention) that shares the target's token
    embedding (``trg_emb``) and position table (``pgd_pe_table``) and runs
    over the SAME paged geometry: its own K/V pools
    ``pgd_draft_{k,v}pool_0 [P, H, ps, dh]`` indexed through the target's
    ``pgd_table`` row per slot, so its cache residency follows the slots'
    page residency with no bookkeeping of its own.

    ``step_prog`` feeds ``draft_tok``/``draft_pos``/``draft_live``
    ``[S, 1]`` and fetches the greedy next token ``[S, 1]`` (rows that
    are not live write to the trash page, attend nothing and emit eos).
    Correctness never depends on this model: the accept walk chooses
    every committed token from TARGET logits, so a stale or randomly
    initialised draft only lowers the acceptance rate. For the same
    reason the draft pools sit OUTSIDE copy-on-write.

    Returns ``(init_prog, step_prog, step_startup_prog, token_name)``.
    ``init_prog`` zero-allocates the draft pools and runs after the paged
    decoder's. ``step_startup_prog`` initialises EVERY parameter the step
    program touches, the shared ``trg_emb`` included, so a session runs
    it only for the variables its scope lacks
    (``serving.speculative.DraftModelDrafter``)."""
    nn = fluid.layers
    S, T, D = int(num_slots), int(max_length), int(d_model)
    dh = D // int(n_head)
    ps = int(page_size)
    npp = pages_for(T, ps)
    P = int(num_pages) if num_pages else 1 + S * npp
    di = int(d_inner) if d_inner else 2 * D

    def heads(x):
        return nn.transpose(nn.reshape(x, shape=[0, 0, n_head, dh]),
                            perm=[0, 2, 1, 3])

    def proj(x, size, name):
        return nn.fc(x, size, num_flatten_dims=2, bias_attr=False, name=name)

    with unique_name.guard({}):
        init = fluid.Program()
        with fluid.program_guard(init, fluid.Program()):
            blk = init.global_block()
            for kind in ("kpool", "vpool"):
                out = blk.create_var(name="pgd_draft_%s_0" % kind,
                                     shape=None, dtype="float32",
                                     persistable=True)
                nn.assign(nn.fill_constant([P, n_head, ps, dh], "float32",
                                           0.0), output=out)

        step = fluid.Program()
        step_startup = fluid.Program()
        with fluid.program_guard(step, step_startup):
            blk = step.global_block()

            def pvar(name, shape, dtype="float32"):
                return blk.create_var(name=name, shape=shape, dtype=dtype,
                                      persistable=True)

            dtok = nn.data("draft_tok", shape=[S, 1], dtype="int64",
                           append_batch_size=False)
            dpos = nn.data("draft_pos", shape=[S, 1], dtype="int64",
                           append_batch_size=False)
            dlive = nn.data("draft_live", shape=[S, 1], dtype="int64",
                            append_batch_size=False)
            ptable = pvar("pgd_table", [S, npp], "int64")
            pe_table = pvar("pgd_pe_table", [T, D])
            kpool = pvar("pgd_draft_kpool_0", [P, n_head, ps, dh])
            vpool = pvar("pgd_draft_vpool_0", [P, n_head, ps, dh])
            ddone = nn.elementwise_sub(
                nn.fill_constant([S, 1], "int64", 1), dlive)
            lengths = nn.elementwise_mul(
                fluid.layers.increment(dpos, value=1, in_place=False),
                dlive)
            write_table = nn.elementwise_mul(ptable, dlive)
            emb = nn.embedding(input=dtok, size=[trg_vocab_size, D],
                               param_attr=fluid.ParamAttr(name="trg_emb"))
            emb = nn.reshape(emb, shape=[0, 1, D])
            pe_row = nn.reshape(
                nn.gather(pe_table, nn.reshape(dpos, shape=[-1])),
                shape=[0, 1, D])
            h = nn.elementwise_add(nn.scale(emb, scale=D ** 0.5), pe_row)
            nx = _prenorm(h, "draft_dec_sattn")
            q = heads(proj(nx, dh * n_head, "draft_dec_smha_q"))
            k1 = heads(proj(nx, dh * n_head, "draft_dec_smha_k"))
            v1 = heads(proj(nx, dh * n_head, "draft_dec_smha_v"))
            kpool, vpool = fluid.layers.paged_kv_write(
                kpool, vpool, k1, v1, write_table, dpos)
            att = fluid.layers.paged_attention(
                q, kpool, vpool, ptable, lengths, sm_scale=dh ** -0.5)
            att = nn.reshape(nn.transpose(att, perm=[0, 2, 1, 3]),
                             shape=[0, 0, n_head * dh])
            h = nn.elementwise_add(h, proj(att, D, "draft_dec_smha_o"))
            ff = _ffn(_prenorm(h, "draft_dec_ffn"), D, di, "draft_dec_ffn")
            h = nn.elementwise_add(h, ff)
            h = _prenorm(h, "draft_final")
            logits = nn.fc(h, trg_vocab_size, num_flatten_dims=2,
                           name="draft_proj_logits")
            dtok_new, _, _ = fluid.layers.slot_decode_sample(
                logits, dpos, done=ddone, eos_id=eos_id, max_length=T)
    return init, step, step_startup, dtok_new.name


def build_cow_batch_prog(num_slots, max_length, n_layer, n_head, d_model,
                         page_size, num_pages, pairs):
    """One coalesced copy-on-write dispatch: copy ``pairs`` KV page pairs
    across every layer's pools, then install the affected slots' final
    table rows (every copy lands before any repoint). Feeds:
    ``src_pages``/``dst_pages``/``slot_idxs`` ``[pairs]`` int64 and
    ``page_rows [pairs, npp]``. Pad entries are ``(src=0, dst=0)``
    trash-page self-copies bound to an unchanged row, a no-op by
    construction. ``pairs`` is a rung of the session's bucket ladder."""
    nn = fluid.layers
    S, T = int(num_slots), int(max_length)
    dh = int(d_model) // int(n_head)
    ps = int(page_size)
    npp = pages_for(T, ps)
    P = int(num_pages)
    n = int(pairs)
    if n < 1:
        raise ValueError("build_cow_batch_prog needs pairs >= 1")
    with unique_name.guard({}):
        prog = fluid.Program()
        with fluid.program_guard(prog, fluid.Program()):
            blk = prog.global_block()
            src_pages = nn.data("src_pages", shape=[n], dtype="int64",
                                append_batch_size=False)
            dst_pages = nn.data("dst_pages", shape=[n], dtype="int64",
                                append_batch_size=False)
            slot_idxs = nn.data("slot_idxs", shape=[n], dtype="int64",
                                append_batch_size=False)
            page_rows = nn.data("page_rows", shape=[n, npp],
                                dtype="int64", append_batch_size=False)
            idxs = [nn.fill_constant([1], "int64", i) for i in range(n)]
            for i in range(n_layer):
                kpool = blk.create_var(name="pgd_kpool_%d" % i,
                                       shape=[P, n_head, ps, dh],
                                       dtype="float32", persistable=True)
                vpool = blk.create_var(name="pgd_vpool_%d" % i,
                                       shape=[P, n_head, ps, dh],
                                       dtype="float32", persistable=True)
                for j in range(n):
                    fluid.layers.paged_copy_page(
                        kpool, vpool, nn.gather(src_pages, idxs[j]),
                        nn.gather(dst_pages, idxs[j]))
            t = blk.create_var(name="pgd_table", shape=[S, npp],
                               dtype="int64", persistable=True)
            for j in range(n):
                nn.dynamic_update_slice(
                    t, nn.gather(page_rows, idxs[j]),
                    nn.gather(slot_idxs, idxs[j]), axis=0, out=t)
    return prog
