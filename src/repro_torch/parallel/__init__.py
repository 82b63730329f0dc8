"""Distribution layer of the port: the paged path's tensor- and
data-parallel attention over a :class:`repro_torch.launch.mesh.Mesh`."""
