"""Frozen arithmetic: operations and bytes from shapes (`seanet`,
`kernels`, `steps`), the card's peaks (`kernels`) and the table of
device-operation groups (`names`)."""
