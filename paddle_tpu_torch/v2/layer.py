"""paddle.v2.layer (``paddle_tpu/v2/layer.py``): the layer ctors
re-exported without the ``_layer`` suffix (reference v2/layer.py
re-exports them through config_base)."""

import paddle_tpu_torch.layers as _L

# v2 names drop the _layer suffix: paddle.layer.fc, .data, .embedding, ...
data = _L.data_layer
fc = _L.fc_layer
embedding = _L.embedding_layer
conv = img_conv = _L.img_conv_layer
pool = img_pool = _L.img_pool_layer
batch_norm = _L.batch_norm_layer
dropout = _L.dropout_layer
addto = _L.addto_layer
concat = _L.concat_layer
mixed = _L.mixed_layer
lstmemory = _L.lstmemory
grumemory = _L.grumemory
recurrent = _L.recurrent_layer
recurrent_group = _L.recurrent_group
memory = _L.memory
beam_search = _L.beam_search
GeneratedInput = _L.GeneratedInput
StaticInput = _L.StaticInput
pooling = _L.pooling_layer
last_seq = _L.last_seq
first_seq = _L.first_seq
expand = _L.expand_layer
seq_concat = _L.seq_concat_layer
seq_reshape = _L.seq_reshape_layer
max_id = _L.maxid_layer
eos = _L.eos_layer
cross_entropy_cost = _L.cross_entropy
classification_cost = _L.classification_cost
regression_cost = square_error_cost = mse_cost = _L.regression_cost
crf = _L.crf_layer
crf_decoding = _L.crf_decoding_layer
ctc = _L.ctc_layer
warp_ctc = _L.warp_ctc_layer
nce = _L.nce_layer
hsigmoid = _L.hsigmoid
rank_cost = _L.rank_cost
lambda_cost = _L.lambda_cost
huber_cost = _L.huber_cost
sum_cost = _L.sum_cost
cos_sim = _L.cos_sim
trans = _L.trans_layer
rotate = _L.rotate_layer
tensor = _L.tensor_layer
scaling = _L.scaling_layer
slope_intercept = _L.slope_intercept_layer
interpolation = _L.interpolation_layer
power = _L.power_layer
sampling_id = _L.sampling_id_layer
maxout = _L.maxout_layer
spp = _L.spp_layer
pad = _L.pad_layer
bilinear_interp = _L.bilinear_interp_layer
block_expand = _L.block_expand_layer
img_cmrnorm = _L.img_cmrnorm_layer
sum_to_one_norm = _L.sum_to_one_norm_layer
repeat = _L.repeat_layer

# projections/operators keep their names
full_matrix_projection = _L.full_matrix_projection
trans_full_matrix_projection = _L.trans_full_matrix_projection
identity_projection = _L.identity_projection
table_projection = _L.table_projection
dotmul_projection = _L.dotmul_projection
scaling_projection = _L.scaling_projection
context_projection = _L.context_projection
conv_projection = _L.conv_projection
dotmul_operator = _L.dotmul_operator
conv_operator = _L.conv_operator

AggregateLevel = _L.AggregateLevel
ExpandLevel = _L.ExpandLevel
LayerOutput = _L.LayerOutput
