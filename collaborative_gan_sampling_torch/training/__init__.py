from collaborative_gan_sampling_torch.training.gan import (  # noqa: F401
    TrainState,
    create_train_state,
    make_train_chunk,
    nonsaturating_d_loss,
    nonsaturating_g_loss,
    sampling_g,
)
from collaborative_gan_sampling_torch.training.shaping import (  # noqa: F401
    ShapingState,
    ShapingStep,
)
