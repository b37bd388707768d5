"""demo/seqToseq/v1's network in the layer DSL
(``demo/seqToseq/v1/seqtoseq_net.py:35-110`` with ``train.conf``): the
attention GRU encoder-decoder that trains as a ``recurrent_group`` and
decodes as ``beam_search`` over a ``GeneratedInput``, the step's layers
shared by name between the two graphs.

Encoder: the source embedding (``_source_language_embedding``) through
``simple_gru(naive=True)`` forward and reversed, each with the demo's
error clipping, concatenated; ``encoded_proj`` (a mixed projection of
it) and ``decoder_boot`` (tanh of a projection of the reversed GRU's
first step).  Decoder step: a ``memory`` named ``gru_decoder`` booted
by ``decoder_boot``, ``simple_attention`` over the encoder, the 3·d
mixed input of the context and the current word, the GRU step
``gru_decoder`` and the softmax over the target vocabulary.  Every
layer and parameter name is the one the JAX package's v1 config parser
gives ``train.conf``, so a JAX parameter tree of that parse loads with
``params_from_numpy``.

On the card the encoder's two GRUs run the GRU kernels (``ops/rnn.gru``'s
rule, B % 8 == 0 and D % 128 == 0); the decoder step and the beam search
are plain PyTorch calls, as they are XLA's in JAX.  Adam lr 5e-4, the
demo's; the data are the ``wmt14`` loader's (src, trg_in, trg_next)
triples.
"""

from paddle_tpu_torch import layers as L
from paddle_tpu_torch.data import reader as reader_mod
from paddle_tpu_torch.data.datasets import wmt14
from paddle_tpu_torch.data.provider import integer_value_sequence
from paddle_tpu_torch.optim import Adam

DIM = 512          # train.conf's word_vector_dim = encoder = decoder size
BEAM = 3
MAX_LENGTH = 250
ERROR_CLIPPING = 50
# train.conf's batch is 50; at 48 the encoder GRUs pass the fused route's
# rule (B % 8 == 0, D % 128 == 0, JAX's and the port's), so the card runs
# the GRU kernels where at 50 both packages take the scan
BATCH = 48
LEARNING_RATE = 5e-4


def gru_encoder_decoder(src_dict_dim, trg_dict_dim, is_generating,
                        word_vector_dim=DIM, encoder_size=DIM,
                        decoder_size=DIM, beam_size=BEAM,
                        max_length=MAX_LENGTH, error_clipping=ERROR_CLIPPING,
                        greedy=False):
    """The demo's network: in training the cost (``classification_cost``
    over the ``decoder_group`` recurrent_group, whose node is the cost's
    first input), in generation the ``decoder_group`` beam_search node
    (bos 0, eos 1), or with ``greedy`` a greedy_generation node over the
    same step."""
    clip = {"error_clipping_threshold": error_clipping}
    src_word = L.data_layer("source_language_word", size=src_dict_dim,
                            is_seq=True)
    src_emb = L.embedding_layer(
        src_word, size=word_vector_dim,
        param_attr={"name": "_source_language_embedding"})
    enc_fwd = L.simple_gru(src_emb, size=encoder_size, naive=True,
                           gru_layer_attr=clip)
    enc_bwd = L.simple_gru(src_emb, size=encoder_size, reverse=True,
                           naive=True, gru_layer_attr=clip)
    encoded_vector = L.concat_layer([enc_fwd, enc_bwd])
    encoded_proj = L.mixed_layer(
        size=decoder_size,
        input=L.full_matrix_projection(encoded_vector))
    decoder_boot = L.mixed_layer(
        size=decoder_size, act="tanh",
        input=L.full_matrix_projection(L.first_seq(enc_bwd)))

    def gru_decoder_with_attention(enc_vec, enc_proj, current_word):
        decoder_mem = L.memory(name="gru_decoder", size=decoder_size,
                               boot_layer=decoder_boot)
        context = L.simple_attention(encoded_sequence=enc_vec,
                                     encoded_proj=enc_proj,
                                     decoder_state=decoder_mem)
        decoder_inputs = L.mixed_layer(
            size=decoder_size * 3,
            input=[L.full_matrix_projection(context),
                   L.full_matrix_projection(current_word)])
        gru_step = L.gru_step_naive_layer(
            name="gru_decoder", input=decoder_inputs,
            output_mem=decoder_mem, size=decoder_size, layer_attr=clip)
        return L.mixed_layer(size=trg_dict_dim, bias_attr=True,
                             act="softmax",
                             input=L.full_matrix_projection(gru_step))

    group_inputs = [L.StaticInput(encoded_vector, is_seq=True),
                    L.StaticInput(encoded_proj, is_seq=True)]
    if not is_generating:
        trg_emb = L.embedding_layer(
            L.data_layer("target_language_word", size=trg_dict_dim,
                         is_seq=True),
            size=word_vector_dim,
            param_attr={"name": "_target_language_embedding"})
        decoder = L.recurrent_group(gru_decoder_with_attention,
                                    group_inputs + [trg_emb],
                                    name="decoder_group")
        label = L.data_layer("target_language_next_word", size=trg_dict_dim,
                             is_seq=True)
        return L.classification_cost(decoder, label)
    trg_emb = L.GeneratedInput(size=trg_dict_dim,
                               embedding_name="_target_language_embedding",
                               embedding_size=word_vector_dim)
    if greedy:
        return L.greedy_generation(gru_decoder_with_attention,
                                   group_inputs + [trg_emb],
                                   name="decoder_group", bos_id=wmt14.START,
                                   eos_id=wmt14.END, max_length=max_length)
    return L.beam_search(gru_decoder_with_attention,
                         group_inputs + [trg_emb], name="decoder_group",
                         bos_id=wmt14.START, eos_id=wmt14.END,
                         beam_size=beam_size, max_length=max_length)


def build(is_generating=False, dim=DIM, src_dict_dim=wmt14.SRC_DICT_SIZE,
          trg_dict_dim=wmt14.TRG_DICT_SIZE, **kw):
    """``gru_encoder_decoder`` at width ``dim`` over the wmt14 loader's
    vocabularies, with a fresh layer-name registry."""
    L.reset_names()
    return gru_encoder_decoder(src_dict_dim, trg_dict_dim, is_generating,
                               word_vector_dim=dim, encoder_size=dim,
                               decoder_size=dim, **kw)


def optimizer():
    return Adam(learning_rate=LEARNING_RATE)


def feeding(src_dict_dim=wmt14.SRC_DICT_SIZE,
            trg_dict_dim=wmt14.TRG_DICT_SIZE):
    """The wmt14 loader's (src, trg_in, trg_next) triples, in order."""
    return {"source_language_word": integer_value_sequence(src_dict_dim),
            "target_language_word": integer_value_sequence(trg_dict_dim),
            "target_language_next_word": integer_value_sequence(
                trg_dict_dim)}


def batches(n_batches=None, batch_size=BATCH):
    """The wmt14 train triples in batches of ``batch_size`` (the first
    ``n_batches``, or all)."""
    return reader_mod.firstn(reader_mod.batch(wmt14.train(), batch_size),
                             n_batches)
