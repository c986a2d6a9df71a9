"""A toy dataset for the data-loader tests of the port, in a module of its
own: ``batch_iterator``'s worker processes start from a fresh server and
import the dataset's class by name, which must not pull in JAX."""

import numpy as np


class Toy:
    """Ten items {"x": (2, 2) float32 filled with the index, "label"};
    item 3 is None (the oversize filter's drop)."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        if i == 3:
            return None
        return {"x": np.full((2, 2), i, np.float32), "label": np.asarray(i, np.int32)}
