from collaborative_gan_sampling_torch.viz.plots import (  # noqa: F401
    plot_2d_overview,
    plot_refinement_trajectories,
    save_image_grid,
    save_teaser_gif,
)
