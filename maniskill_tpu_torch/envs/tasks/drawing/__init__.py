from .draw import TableTopFreeDrawEnv
from .draw_triangle import DrawTriangleEnv
from .draw_svg import DrawSVGEnv
