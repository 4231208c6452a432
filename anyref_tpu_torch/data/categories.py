"""Category tables (standard public datasets).

COCO: the 80 "thing" classes keyed by their official annotation ids (ids
1-90 with gaps). ADE20K: the 100-class instance subset and the 150-class
semantic list. These replace the reference's vendored tables
(utils/coco_category.py, utils/ade_ins_category.py) with the same public
mappings.
"""

COCO_THING_CLASSES = {
    1: "person", 2: "bicycle", 3: "car", 4: "motorcycle", 5: "airplane",
    6: "bus", 7: "train", 8: "truck", 9: "boat", 10: "traffic light",
    11: "fire hydrant", 13: "stop sign", 14: "parking meter", 15: "bench",
    16: "bird", 17: "cat", 18: "dog", 19: "horse", 20: "sheep", 21: "cow",
    22: "elephant", 23: "bear", 24: "zebra", 25: "giraffe", 27: "backpack",
    28: "umbrella", 31: "handbag", 32: "tie", 33: "suitcase", 34: "frisbee",
    35: "skis", 36: "snowboard", 37: "sports ball", 38: "kite",
    39: "baseball bat", 40: "baseball glove", 41: "skateboard",
    42: "surfboard", 43: "tennis racket", 44: "bottle", 46: "wine glass",
    47: "cup", 48: "fork", 49: "knife", 50: "spoon", 51: "bowl",
    52: "banana", 53: "apple", 54: "sandwich", 55: "orange", 56: "broccoli",
    57: "carrot", 58: "hot dog", 59: "pizza", 60: "donut", 61: "cake",
    62: "chair", 63: "couch", 64: "potted plant", 65: "bed",
    67: "dining table", 70: "toilet", 72: "tv", 73: "laptop", 74: "mouse",
    75: "remote", 76: "keyboard", 77: "cell phone", 78: "microwave",
    79: "oven", 80: "toaster", 81: "sink", 82: "refrigerator", 84: "book",
    85: "clock", 86: "vase", 87: "scissors", 88: "teddy bear",
    89: "hair drier", 90: "toothbrush",
}

ADE_INSTANCE_CLASSES = {
    1: "bed", 2: "windowpane", 3: "cabinet", 4: "person", 5: "door",
    6: "table", 7: "curtain", 8: "chair", 9: "car", 10: "painting",
    11: "sofa", 12: "shelf", 13: "mirror", 14: "armchair", 15: "seat",
    16: "fence", 17: "desk", 18: "wardrobe", 19: "lamp", 20: "bathtub",
    21: "railing", 22: "cushion", 23: "box", 24: "column", 25: "signboard",
    26: "chest of drawers", 27: "counter", 28: "sink", 29: "fireplace",
    30: "refrigerator", 31: "stairs", 32: "case", 33: "pool table",
    34: "pillow", 35: "screen door", 36: "bookcase", 37: "coffee table",
    38: "toilet", 39: "flower", 40: "book", 41: "bench", 42: "countertop",
    43: "stove", 44: "palm", 45: "kitchen island", 46: "computer",
    47: "swivel chair", 48: "boat", 49: "arcade machine", 50: "bus",
    51: "towel", 52: "light", 53: "truck", 54: "chandelier", 55: "awning",
    56: "streetlight", 57: "booth", 58: "television receiver",
    59: "airplane", 60: "apparel", 61: "pole", 62: "bannister",
    63: "ottoman", 64: "bottle", 65: "van", 66: "ship", 67: "fountain",
    68: "washer", 69: "plaything", 70: "stool", 71: "barrel", 72: "basket",
    73: "bag", 74: "minibike", 75: "oven", 76: "ball", 77: "food",
    78: "step", 79: "trade name", 80: "microwave", 81: "pot", 82: "animal",
    83: "bicycle", 84: "dishwasher", 85: "screen", 86: "sculpture",
    87: "hood", 88: "sconce", 89: "vase", 90: "traffic light", 91: "tray",
    92: "ashcan", 93: "fan", 94: "plate", 95: "monitor",
    96: "bulletin board", 97: "radiator", 98: "glass", 99: "clock",
    100: "flag",
}

ADE_SEMANTIC_CLASSES = [
    "wall", "building", "sky", "floor", "tree", "ceiling", "road", "bed",
    "windowpane", "grass", "cabinet", "sidewalk", "person", "earth", "door",
    "table", "mountain", "plant", "curtain", "chair", "car", "water",
    "painting", "sofa", "shelf", "house", "sea", "mirror", "rug", "field",
    "armchair", "seat", "fence", "desk", "rock", "wardrobe", "lamp",
    "bathtub", "railing", "cushion", "base", "box", "column", "signboard",
    "chest of drawers", "counter", "sand", "sink", "skyscraper",
    "fireplace", "refrigerator", "grandstand", "path", "stairs", "runway",
    "case", "pool table", "pillow", "screen door", "stairway", "river",
    "bridge", "bookcase", "blind", "coffee table", "toilet", "flower",
    "book", "hill", "bench", "countertop", "stove", "palm",
    "kitchen island", "computer", "swivel chair", "boat", "bar",
    "arcade machine", "hovel", "bus", "towel", "light", "truck", "tower",
    "chandelier", "awning", "streetlight", "booth", "television receiver",
    "airplane", "dirt track", "apparel", "pole", "land", "bannister",
    "escalator", "ottoman", "bottle", "buffet", "poster", "stage", "van",
    "ship", "fountain", "conveyer belt", "canopy", "washer", "plaything",
    "swimming pool", "stool", "barrel", "basket", "waterfall", "tent",
    "bag", "minibike", "cradle", "oven", "ball", "food", "step", "tank",
    "trade name", "microwave", "pot", "animal", "bicycle", "lake",
    "dishwasher", "screen", "blanket", "sculpture", "hood", "sconce",
    "vase", "traffic light", "tray", "ashcan", "fan", "pier", "crt screen",
    "plate", "monitor", "bulletin board", "shower", "radiator", "glass",
    "clock", "flag",
]
