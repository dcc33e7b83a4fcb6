"""Visualization helpers (a copy of the JAX package's ``utils/vis_utils.py``;
reference ``robomimic/utils/vis_utils.py:145``):
model-prediction plots comparing actual vs predicted action trajectories."""

import os

import numpy as np


def make_model_prediction_plot(hdf5_path, save_path, action_names,
                               actual_actions, predicted_actions, images=None):
    """One subplot per action dim: actual vs predicted over time
    (reference vis_utils.py:145-220). @images optionally shows sampled
    frames above the traces."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    actual_actions = np.asarray(actual_actions)
    predicted_actions = np.asarray(predicted_actions)
    t, d = actual_actions.shape
    n_img_rows = 1 if images is not None else 0
    fig, axes = plt.subplots(
        d + n_img_rows, 1, figsize=(10, 2.0 * (d + n_img_rows)), squeeze=False
    )
    row = 0
    if images is not None:
        strip = np.concatenate(list(images), axis=1)
        axes[0][0].imshow(strip)
        axes[0][0].axis("off")
        row = 1
    for i in range(d):
        ax = axes[row + i][0]
        ax.plot(np.arange(t), actual_actions[:, i], label="actual")
        ax.plot(np.arange(t), predicted_actions[:, i], label="predicted")
        name = action_names[i] if i < len(action_names) else f"dim_{i}"
        ax.set_ylabel(name, fontsize=8)
        if i == 0:
            ax.legend(loc="upper right", fontsize=8)
            ax.set_title(os.path.basename(str(hdf5_path)), fontsize=9)
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    fig.tight_layout()
    fig.savefig(save_path, dpi=80)
    plt.close(fig)
    return save_path

