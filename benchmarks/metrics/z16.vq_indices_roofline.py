"""% of vq_indices' device time that its roofline (the larger of its bytes
over the HBM rate and its distance products over the fp32 rate) takes."""
from yardstick.readers import vq_indices_roofline as read  # noqa: F401
