"""Image file IO helpers (host side, PIL-backed): a copy of
``fast_srgan_tpu/utils/images.py`` (the port imports nothing of that
package)."""

from __future__ import annotations

import os
from typing import List

import numpy as np

# Same extension set the reference CLI accepts (inference.py:37-45), matched
# case-insensitively. (The reference matches a bare "jpeg" suffix without the
# dot — a quirk normalized here to proper extensions.)
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg")


def list_image_files(directory: str) -> List[str]:
    """Sorted image basenames in a directory (reference inference.py:37-45)."""
    return sorted(
        f for f in os.listdir(directory)
        if f.lower().endswith(IMAGE_EXTENSIONS)
    )


def load_image_u8(path: str) -> np.ndarray:
    """Load an image as uint8 HWC RGB."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


def save_image_u8(path: str, image: np.ndarray) -> None:
    """Save a uint8 HWC RGB array as an image file."""
    from PIL import Image

    Image.fromarray(image).save(path)
