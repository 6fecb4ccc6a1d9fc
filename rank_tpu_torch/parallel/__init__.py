from .mesh import (DATA_AXIS, TABLE_AXIS, Mesh, barrier, init_distributed, is_writer,
                   local_device, make_mesh)

__all__ = ["DATA_AXIS", "TABLE_AXIS", "Mesh", "barrier", "init_distributed", "is_writer",
           "local_device", "make_mesh"]
