from .encoder import EmbeddingModel, EncoderConfig, encode, init_params, tokenize_batch
from .moe import moe_ffn
from .pretrain import (
    PretrainConfig, contrastive_pairs, ict_pairs, load_params,
    pretrain_encoder, save_params,
)
from .train import TrainConfig, contrastive_loss, init_training, make_train_step
