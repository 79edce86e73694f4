from fdt_torch.data.anno import AnnoRecord, generate_anno_file, parse_anno_file, validate_anno_file
from fdt_torch.data.collector import EvalCollector
from fdt_torch.data.frames import fit_frame, read_frames
from fdt_torch.data.image_io import image_size, imdecode, imread

__all__ = ["AnnoRecord", "generate_anno_file", "parse_anno_file", "validate_anno_file",
           "EvalCollector", "imdecode", "imread", "image_size", "read_frames", "fit_frame"]
