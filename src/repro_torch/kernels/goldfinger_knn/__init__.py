"""GoldFinger-Jaccard top-k sweep (build Step 2): ``ops`` + plain ``ref``."""
from repro_torch.kernels.goldfinger_knn import ops, ref  # noqa: F401
