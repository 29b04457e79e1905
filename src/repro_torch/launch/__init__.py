"""Device placement for the port's runtimes (counterpart of ``repro.launch``;
only the box-mesh helpers the sharded PIC runtime uses)."""
from .mesh import make_box_mesh, ring_distance, ring_offset, slot_home_devices

__all__ = ["make_box_mesh", "ring_offset", "ring_distance", "slot_home_devices"]
