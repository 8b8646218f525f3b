"""BEBR core: recurrent binarization, contrastive training, compatibility."""

from repro_torch.core.binarize_lib import (
    SDC_NEG_INF,
    BinarizerConfig,
    binarize,
    binarize_eval,
    code_affine_constants,
    codes_to_values,
    init_binarizer,
    make_eager_encode_fn,
    make_encode_fn,
    pack_bitplanes,
    pack_codes,
    pack_codes_nibbles,
    sdc_affine_epilogue,
    ste_sign,
    unpack_bitplanes,
    unpack_codes,
    unpack_codes_nibbles,
    unpack_nibble_planes,
    values_to_codes,
)
from repro_torch.core.trainer import (
    TrainConfig,
    TrainState,
    bc_train_step,
    init_train_state,
    train_step,
)
