"""Train / serve steps, device meshes, and the dry run that plans each
(arch x shape x mesh) cell on the meta device."""
