"""A frozen copy of the port's host geometry code (numpy only).

grid, basis, quadrature, levelset, tables and geometry are copied from
the port's host modules with their imports made local and the optional
native root finder left out (numpy's roots stand in for it).  The
reference builds its own cut geometry and quadrature from these, so it
takes no table that the program under test computed.  Do not edit them
to follow the program: they are the yardstick.
"""
