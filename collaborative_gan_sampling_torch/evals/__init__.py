from collaborative_gan_sampling_torch.evals.metrics2d import (  # noqa: F401
    metrics_2d,
    mode_assignments,
)
from collaborative_gan_sampling_torch.evals.fid import (  # noqa: F401
    FIDStats,
    fid_between,
    frechet_distance,
    stats_from_features,
    streaming_stats,
)
from collaborative_gan_sampling_torch.evals.features import (  # noqa: F401
    make_feature_fn,
)
from collaborative_gan_sampling_torch.evals.prd import (  # noqa: F401
    precision_recall,
)
from collaborative_gan_sampling_torch.evals.kid import (  # noqa: F401
    kid,
    mmd2_unbiased,
)
