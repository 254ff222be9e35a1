"""Operations and bytes of the program's hand-written kernels, one module a
kernel, and the roofline share they give with a device trace."""
