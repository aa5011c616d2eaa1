"""paddle.nn.functional of the port (counterpart of
paddle_tpu/nn/functional): the activations, `one_hot`, `pad` and the
`nn_ops` surface, each through the op dispatch. The port's own modules
keep importing torch's functional under their own name, so the two never
mix."""
from ...ops.activation import (
    rrelu, thresholded_relu,
    celu, elu, gelu, glu, gumbel_softmax, hardshrink, hardsigmoid, hardswish,
    hardtanh, leaky_relu, log_sigmoid, log_softmax, maxout, mish, prelu, relu,
    relu6, selu, sigmoid, silu, softmax, softplus, softshrink, softsign,
    swish, tanh, tanhshrink,
)
from ...ops.creation import one_hot
from ...ops.manipulation import pad
from ...ops.nn_ops import (
    adaptive_avg_pool2d, adaptive_max_pool2d, affine_grid, avg_pool1d,
    avg_pool2d, batch_norm, bce_loss, bce_with_logits, conv1d, conv2d,
    conv2d_transpose, conv3d, cosine_similarity, cross_entropy, dropout,
    dropout2d, embedding, fused_bias_dropout_residual_layer_norm, grid_sample,
    group_norm, hinge_embedding_loss, instance_norm, interpolate, kl_div,
    l1_loss, label_smooth, layer_norm, linear, margin_ranking_loss,
    max_pool1d, max_pool2d, mse_loss, nll_loss, pixel_shuffle, rms_norm,
    scaled_dot_product_attention, smooth_l1_loss, softmax_with_cross_entropy,
    temporal_shift, unfold, fold, max_pool3d, avg_pool3d, normalize,
    local_response_norm, dropout3d, alpha_dropout, pixel_unshuffle,
    sequence_mask, square_error_cost, log_loss, sigmoid_focal_loss,
    dice_loss, npair_loss, triplet_margin_loss, cosine_embedding_loss,
    margin_cross_entropy, ctc_loss,
)

binary_cross_entropy = bce_loss
binary_cross_entropy_with_logits = bce_with_logits
upsample = interpolate
