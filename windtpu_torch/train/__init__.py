from windtpu_torch.train.losses import (  # noqa: F401
    discriminator_loss,
    generator_adversarial_loss,
    gradient_penalty,
)
from windtpu_torch.train.optim import (  # noqa: F401
    discriminator_optimizer,
    generator_optimizer,
)
from windtpu_torch.train.state import (  # noqa: F401
    GANTrainState,
    create_train_state,
)
from windtpu_torch.train.wgan_gp import (  # noqa: F401
    draw_step_noise,
    make_eval_step,
    make_train_step,
)
