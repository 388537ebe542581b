"""PIC PRK particle-push kernel."""
from repro_torch.kernels.pic_push.ops import pic_push  # noqa: F401
