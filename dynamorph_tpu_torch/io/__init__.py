from .pickles import load_pickle, save_pickle
from .sites import get_im_sites, group_sites_by_well, well_of
from .images import im_adjust, read_image, read_multipage_tiff
